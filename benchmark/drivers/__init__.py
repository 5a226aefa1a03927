"""One module a kind of traffic, found by the ``kind`` its traffic file
names (``harness/spec.py``): each gives ``WORK`` ("train" or "serve", what
the per-layer readers look for), ``setup``, ``window``, ``end_to_end``,
``release`` and ``check``. A new kind of traffic is a new file here."""
