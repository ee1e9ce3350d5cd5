"""The verifier's host marshalling: the verify.marshal span a batch
(vk_x ladders included), median over the traced batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("verify.marshal"))
