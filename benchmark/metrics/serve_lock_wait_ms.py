"""serve_lock_wait_ms: the host's time in the program's ``serve.lock_wait``
spans (each wait to take the service's device lock: the forward's and the
fetch's) a request of the traced stretch, in ms. Moves serve_rps."""

from benchmark.harness.spans import per_item_ms


def read(w):
    return per_item_ms(w, "serve", "serve.lock_wait")
