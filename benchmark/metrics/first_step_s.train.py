"""first_step_s.train: the process's first ``train.step`` span, in s: the
first checked step of set-up, which loads the kernels' libraries, makes
cuFFT's plans and cuDNN's choices; no traced stretch sees it. Moves
setup_s."""

from benchmark.harness.spans import first_s


def read(w):
    return first_s("train.step") if w.kind == "train" else None
