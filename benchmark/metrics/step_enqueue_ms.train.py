"""step_enqueue_ms.train: the host's time in the program's ``train.step``
spans (each fused step's crop, forward, loss, backward and Adam, enqueued)
a step of the traced stretch, in ms, under the profiler's few microseconds
an operation. Where the card paces (float32), it holds the host's waits on
a full launch queue, so reads close to the step; where the host paces
(bfloat16), the host's own work. Moves train_mpbs."""

from benchmark.harness.spans import per_item_ms


def read(w):
    return per_item_ms(w, "train", "train.step")
