"""untraced_idle_pct.train_li224: untraced_idle_pct.train's reader, read in
the 224-band training cell, where it moves train_mpbs."""

from benchmark.harness.spec import metric_reader

read = metric_reader("untraced_idle_pct.train")
