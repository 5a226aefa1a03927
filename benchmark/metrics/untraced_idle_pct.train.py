"""untraced_idle_pct.train: an estimate of the share of the untraced
window in which the card ran nothing, in %: 1 - (the card's busy seconds a
step in the traced stretch) x (the window's steps) / (the window's length
on the host's clock). It assumes that the profiler slows the host and not
the card, so that the busy time a step carries over from the traced stretch;
a reading below 0 says that assumption failed. Moves train_mpbs."""


def read(w):
    busy = w.busy_per_item()
    if w.kind != "train" or busy is None or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - busy * w.items / w.seconds)
