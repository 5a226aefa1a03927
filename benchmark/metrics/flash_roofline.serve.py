"""flash_roofline.serve: the flash attention kernel's share of its roofline,
in %: the bounds of the launches the port's counters recorded
(``yardstick.flash_work``: operations, exponentials, bytes) over the trace's
time of the ``flash_*`` kernels. Flash runs only past 2048 tokens, so at
512^2 (S = 4096) and not in the 128^2 training steps. Moves serve_rps."""

from benchmark.harness.yardstick import flash_work, roofline_pct

PATTERNS = ("flash_",)


def read(w):
    if w.kind != "serve" or w.trace is None:
        return None
    return roofline_pct(w.launches.get("flash", {}), w.trace.seconds_matching(PATTERNS),
                        flash_work, ("forward",))
