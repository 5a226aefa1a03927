"""conv9_roofline.train_bf16: conv9_roofline.train's reader, read in the bfloat16
training cell, where it moves train_mpbs.bf16."""

from benchmark.harness.spec import metric_reader

read = metric_reader("conv9_roofline.train")
