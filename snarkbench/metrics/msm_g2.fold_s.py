"""The G2 MSM's window fold: its msm.fold span under prove.msm_g2, median
over the traced proofs."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds(
        "msm.fold", under="prove.msm_g2"))
