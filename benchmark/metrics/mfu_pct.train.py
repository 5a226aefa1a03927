"""mfu_pct.train: the model's operations (counted from its layer shapes,
``yardstick.train_step_flops``) of every step the window completed, over
the window and the card's peak in the configuration's precision (float32
67 TFLOP/s with TF32 off, bfloat16 989), in %. Moves train_mpbs."""

from benchmark.harness.yardstick import PEAK_FLOPS


def read(w):
    if w.kind != "train" or w.items == 0:
        return None
    return 100.0 * w.items * w.item_flops / w.seconds / PEAK_FLOPS[w.precision]
