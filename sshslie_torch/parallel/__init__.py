"""Data and space parallelism over ``torch.distributed`` (``mesh.py``,
``distributed.py``, ``spatial.py``), as ``sshslie_tpu/parallel``: one process
per GPU, replicated weights, the global batch split across the data axis and
the patch height across the space axis."""
