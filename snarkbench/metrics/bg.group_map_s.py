"""The Bowe-Gabizon verifier's group map on the device: the bg.group_map
span a batch, median over the traced batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("bg.group_map"))
