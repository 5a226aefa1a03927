"""mfu_pct.train_li224: mfu_pct.train's reader, read in the 224-band training
cell, where it moves train_mpbs."""

from benchmark.harness.spec import metric_reader

read = metric_reader("mfu_pct.train")
