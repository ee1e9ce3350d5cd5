"""The verifier's vk_x ladders: the sum of a batch's verify.vk_x spans (one
a lane), median over the traced batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("verify.vk_x"))
