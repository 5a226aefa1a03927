"""graph_replay_pct.train_li224: graph_replay_pct.train's reader, read in the
224-band training cell, where it says that the wide kernels and the
shallow conv's cuDNN input gradient replay inside the step's CUDA graph.
Moves train_mpbs."""

from benchmark.harness.spec import metric_reader

read = metric_reader("graph_replay_pct.train")
