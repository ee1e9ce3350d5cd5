"""The MSMs' least time (counts/msm.py: the five MSMs of a proof at their
sizes) over the device's busy time inside the msm_g1 and msm_g2 phases
of the traced proofs, in %."""
from snarkbench.readings import (least, phase_busy, phase_count, prove_work,
                                 roofline_pct)


def read(rec):
    if rec.trace is None:
        return None
    n = min(phase_count(rec, "msm_g1"), phase_count(rec, "msm_g2"))
    busy = phase_busy(rec, ("msm_g1", "msm_g2"))
    return roofline_pct(n * least(prove_work(rec.sizes)["msm"]), busy) \
        if n else None
