"""conv9_roofline.train: the conv9 kernel's share of its roofline in a
training window, in %: the bounds of the forward and input-gradient
launches the port's counters recorded (``yardstick.conv9_work`` at the
precision's peak and 3.35 TB/s) over the trace's time of the conv9 kernels
(``conv_c64*``, the float32 entry's prep kernel included). Moves
train_mpbs."""

from benchmark.harness.yardstick import conv9_work, roofline_pct

PATTERNS = ("conv_c64",)


def read(w):
    if w.kind != "train" or w.trace is None:
        return None
    return roofline_pct(w.launches.get("conv9", {}), w.trace.seconds_matching(PATTERNS),
                        conv9_work, ("forward", "dgrad"))
