"""The G2 MSM's triangle: its msm.triangle (the suffix seg_scan) and
msm.reduce (reduce_last) spans under prove.msm_g2, median over the traced
proofs."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds(
        "msm.triangle", "msm.reduce", under="prove.msm_g2"))
