"""The prover's synchronized msm_g2 phase (prove(timings=)), median over
the traced window's proofs."""
from snarkbench.readings import median_phase


def read(rec):
    return median_phase(rec, "msm_g2")
