"""conv9_roofline.serve: the conv9 kernel's share of its roofline in a
serving window, in %: the bounds of the launches the port's counters
recorded (``yardstick.conv9_work``) over the trace's time of the conv9
kernels (``conv_c64*``, prep kernel included). Moves serve_rps."""

from benchmark.harness.yardstick import conv9_work, roofline_pct

PATTERNS = ("conv_c64",)


def read(w):
    if w.kind != "serve" or w.trace is None:
        return None
    return roofline_pct(w.launches.get("conv9", {}), w.trace.seconds_matching(PATTERNS),
                        conv9_work, ("forward", "dgrad"))
