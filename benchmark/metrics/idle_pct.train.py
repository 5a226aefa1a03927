"""idle_pct.train: the share of the traced stretch of a training window in
which the card ran nothing (no kernel, copy or set), in %: 1 - busy_s /
window_s of the trace. The profiler slows the host, so this reads higher
than the untraced window's (``untraced_idle_pct.train``). Moves
train_mpbs."""


def read(w):
    if w.kind != "train" or w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
