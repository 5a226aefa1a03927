"""first_step_s.train_li224: first_step_s.train's reader, read in the
224-band training cell, where the first step also builds the wide kernels'
library."""

from benchmark.harness.spec import metric_reader

read = metric_reader("first_step_s.train")
