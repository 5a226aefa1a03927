"""cudnn_ms.train_li224: cudnn_ms.train's reader, read in the 224-band training
cell, where it moves train_mpbs."""

from benchmark.harness.spec import metric_reader

read = metric_reader("cudnn_ms.train")
