"""The prover's prove.calc_h span (CALC_H, ends after its synchronize in a
traced window), median over the traced window's proofs."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("prove.calc_h"))
