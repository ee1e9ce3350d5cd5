"""The port's kernel launches recorded on the prove.msm_g2 span, median
over the traced proofs."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    def launches(o):
        found = o.named("prove.msm_g2")
        return sum(s.launches for s in found) if found else None
    return median_over_ops(rec, launches)
