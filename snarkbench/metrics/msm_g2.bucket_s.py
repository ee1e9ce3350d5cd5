"""The G2 MSM's buckets: its msm.digits, msm.sort and msm.bucket_scan
spans under prove.msm_g2, median over the traced proofs."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds(
        "msm.digits", "msm.sort", "msm.bucket_scan", under="prove.msm_g2"))
