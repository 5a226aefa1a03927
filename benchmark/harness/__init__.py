"""The benchmark's harness: the cell spec, the inputs made from the seed,
the trace reduction, the yardstick (peaks, operation and byte counts) and
the comparison that decides ``correct``."""
