"""graph_replay_pct.train: the share of the traced stretch's fused steps that
replayed a CUDA graph of the step, in %: 100 x the program's ``train.replay``
spans over its ``train.step`` spans (the tracer's counts, ``harness/spans.py``).
None where the program has no ``train.replay`` span (a checkout without the
graph). Moves train_mpbs."""

from benchmark.harness.spans import _tracer


def read(w):
    if w.kind != "train" or w.trace is None:
        return None
    tracer = _tracer()
    rows = {} if tracer is None else tracer.summary()
    replays, steps = rows.get("train.replay"), rows.get("train.step")
    if replays is None or not steps or not steps["count"]:
        return None
    return 100.0 * replays["count"] / steps["count"]
