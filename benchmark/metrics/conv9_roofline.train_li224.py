"""conv9_roofline.train_li224: the wide float32 conv9's share of its
roofline in the 224-band training cell, in %: the bounds of the
"wide_forward" launches the port's counters recorded
(``harness/wide.py::wide_conv_work`` at 67 TFLOP/s and 3.35 TB/s) over the
trace's time of the wide kernels (``wide_f32*``, the prep kernel included).
The input gradient of that conv runs on cuDNN and is not read here. None
where no wide launch ran (a program without the wide entry). Moves
train_mpbs."""

from benchmark.harness.wide import wide_conv_work
from benchmark.harness.yardstick import roofline_pct

PATTERNS = ("wide_f32",)


def read(w):
    if w.kind != "train" or w.trace is None:
        return None
    return roofline_pct(w.launches.get("conv9", {}), w.trace.seconds_matching(PATTERNS),
                        wide_conv_work, ("wide_forward",))
