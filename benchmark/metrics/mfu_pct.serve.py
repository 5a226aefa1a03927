"""mfu_pct.serve: the model's operations (one forward a request,
``yardstick.request_flops``) of every request the window answered, over the
window and the card's peak in the configuration's precision, in %. Moves
serve_rps."""

from benchmark.harness.yardstick import PEAK_FLOPS


def read(w):
    if w.kind != "serve" or w.items == 0:
        return None
    return 100.0 * w.items * w.item_flops / w.seconds / PEAK_FLOPS[w.precision]
