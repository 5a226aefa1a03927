"""graph_replay_pct.train_bf16: graph_replay_pct.train's reader, read in the
bfloat16 training cell, where it moves train_mpbs.bf16."""

from benchmark.harness.spec import metric_reader

read = metric_reader("graph_replay_pct.train")
