"""cudnn_ms.train: the time of cuDNN's convolution kernels (the class
"convolutions (cuDNN)" of ``trace.KERNEL_CLASSES``, by name) a step in the
traced stretch, in ms. Moves train_mpbs."""

CLASS = "convolutions (cuDNN)"


def read(w):
    if w.kind != "train" or w.trace is None or w.traced_items == 0:
        return None
    s = w.trace.class_seconds(CLASS)
    return 1e3 * s / w.traced_items if s > 0 else None
