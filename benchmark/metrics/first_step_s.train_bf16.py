"""first_step_s.train_bf16: first_step_s.train's reader, read in the
bfloat16 training cell."""

from benchmark.harness.spec import metric_reader

read = metric_reader("first_step_s.train")
