"""step_enqueue_ms.train_li224: step_enqueue_ms.train's reader, read in the
224-band training cell, where it moves train_mpbs."""

from benchmark.harness.spec import metric_reader

read = metric_reader("step_enqueue_ms.train")
