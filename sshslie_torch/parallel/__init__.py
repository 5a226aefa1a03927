"""Data parallelism over ``torch.distributed`` (``mesh.py``, ``distributed.py``),
as ``sshslie_tpu/parallel``: one process per GPU, replicated weights, the
global batch split across ranks."""
