"""cudnn_ms.serve: the time of cuDNN's convolution kernels (the class
"convolutions (cuDNN)" of ``trace.KERNEL_CLASSES``, by name) a request in
the traced stretch, in ms. Moves serve_rps."""

CLASS = "convolutions (cuDNN)"


def read(w):
    if w.kind != "serve" or w.trace is None or w.traced_items == 0:
        return None
    s = w.trace.class_seconds(CLASS)
    return 1e3 * s / w.traced_items if s > 0 else None
