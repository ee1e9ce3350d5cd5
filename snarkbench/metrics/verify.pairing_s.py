"""The verifier's device pairing: the verify.pairing span a batch (pi_b's
ladder, the Miller loops, the final exponentiation and the verdicts' copy
to the host), median over the traced batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("verify.pairing"))
