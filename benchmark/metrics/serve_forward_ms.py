"""serve_forward_ms: the service's own X-Inference-Seconds region (upload,
decode and forward, ending in a synchronize; ``EnhanceService.stats()``),
averaged over the window's requests, in ms. Moves serve_rps."""


def read(w):
    if w.kind != "serve" or not w.service.get("requests"):
        return None
    return 1e3 * w.service["seconds"] / w.service["requests"]
