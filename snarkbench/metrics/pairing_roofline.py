"""The batches' least pairing time (counts/pairing.py at the batch's
lanes) over the device's busy time inside the verify calls, in %."""
from snarkbench.readings import least, phase_busy, roofline_pct, verify_work


def read(rec):
    if rec.trace is None:
        return None
    calls = [(a, b) for label, a, b in rec.phases if label == "verify"]
    if not calls:
        return None
    work = sum(least(verify_work(rec.sizes, op.lanes)["pairing"])
               for op in rec.done[:len(calls)])
    return roofline_pct(work, phase_busy(rec, ("verify",)))
