"""The prover's synchronized msm_g1 phase (the four stacked G1 MSMs),
median over the traced window's proofs."""
from snarkbench.readings import median_phase


def read(rec):
    return median_phase(rec, "msm_g1")
