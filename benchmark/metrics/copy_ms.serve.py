"""copy_ms.serve: the card's time in host-device copies a request in the
traced stretch (the trace's "Memcpy HtoD" and "Memcpy DtoH" operations: the
request's u16 upload and the codes' fetch), in ms. Moves serve_rps."""

PATTERNS = ("Memcpy HtoD", "Memcpy DtoH")


def read(w):
    if w.kind != "serve" or w.trace is None or w.traced_items == 0:
        return None
    s = w.trace.seconds_matching(PATTERNS)
    return 1e3 * s / w.traced_items if s > 0 else None
