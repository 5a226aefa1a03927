"""serve_fetch_ms: the host's time in the program's ``serve.fetch`` spans (S
cropped and quantized to u16 on the card, then the codes and their affine
copied back to pageable memory, with the wait for the device lock) a
request of the traced stretch, in ms. Moves serve_rps."""

from benchmark.harness.spans import per_item_ms


def read(w):
    return per_item_ms(w, "serve", "serve.fetch")
