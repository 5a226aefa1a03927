"""idle_pct.serve: the share of the traced stretch of a serving window in
which the card ran nothing (no kernel, copy or set), in %: 1 - busy_s /
window_s of the trace. One closed-loop client, so the idle time is the
host's share of each request. Moves serve_rps."""


def read(w):
    if w.kind != "serve" or w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
