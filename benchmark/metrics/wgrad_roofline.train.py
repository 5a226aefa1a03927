"""wgrad_roofline.train: conv9_wgrad's share of its roofline, in %: the
bounds of the launches the port's counters recorded
(``yardstick.wgrad_work``) over the trace's time of its kernels (the
partials ``wgrad_c64*`` and ``wgrad_reduce_kernel``). Moves train_mpbs."""

from benchmark.harness.yardstick import roofline_pct, wgrad_work

PATTERNS = ("wgrad_c64", "wgrad_reduce")


def read(w):
    if w.kind != "train" or w.trace is None:
        return None
    return roofline_pct(w.launches.get("wgrad", {}), w.trace.seconds_matching(PATTERNS),
                        wgrad_work, ("wgrad",))
