"""step_enqueue_ms.train_bf16: step_enqueue_ms.train's reader, read in the
bfloat16 training cell, where it moves train_mpbs.bf16."""

from benchmark.harness.spec import metric_reader

read = metric_reader("step_enqueue_ms.train")
