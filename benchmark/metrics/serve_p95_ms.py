"""serve_p95_ms: the 95th percentile of every request of the untraced
window, each timed from the client's call until it holds the codes, in ms.
One closed-loop client keeps the service busy, so this tail rides the
shared host and is no end-to-end metric here (its spread is wider than a
bound may be). Moves serve_rps."""

import numpy as np


def read(w):
    if w.kind != "serve" or not w.latencies:
        return None
    return 1e3 * float(np.percentile(w.latencies, 95))
