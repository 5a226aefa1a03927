"""wgrad_roofline.train_li224: the wide float32 conv9_wgrad's share of its
roofline in the 224-band training cell, in %: the bounds of the
"wide_wgrad" launches the port's counters recorded
(``harness/wide.py::wide_wgrad_work``) over the trace's time of its kernels
(the partials ``wgrad_c64_kernel<K, 0>`` and ``wgrad_reduce_kernel``, the
64-channel entry's kernels at another instantiation: in this cell the only
conv9 is the 224-band shallow conv, so every launch of those names is a
wide one). None where no wide launch ran. Moves train_mpbs."""

from benchmark.harness.wide import wide_wgrad_work
from benchmark.harness.yardstick import roofline_pct

PATTERNS = ("wgrad_c64", "wgrad_reduce")


def read(w):
    if w.kind != "train" or w.trace is None:
        return None
    return roofline_pct(w.launches.get("wgrad", {}), w.trace.seconds_matching(PATTERNS),
                        wide_wgrad_work, ("wide_wgrad",))
