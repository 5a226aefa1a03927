"""wgrad_roofline.train_bf16: wgrad_roofline.train's reader, read in the bfloat16
training cell, where it moves train_mpbs.bf16."""

from benchmark.harness.spec import metric_reader

read = metric_reader("wgrad_roofline.train")
