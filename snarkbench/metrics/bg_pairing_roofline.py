"""A batch's least time for its five-pair prepared products and final
exponentiations (counts/mnt6753.py at the lanes that reach the pairing,
24-word Fp) over the device's busy time inside its bg.pairing span placed
on the trace's clock, over the traced batches, in %."""
from snarkbench.counts import least_s
from snarkbench.counts.mnt6753 import verify_batch
from snarkbench.program_spans import busy_in, by_op
from snarkbench.readings import roofline_pct


def read(rec):
    if rec.trace is None:
        return None
    busy = [b for b in (busy_in(rec.trace, o, "bg.pairing")
                        for o in by_op(rec)) if b is not None]
    if not busy:
        return None
    ops, nbytes = verify_batch(rec.sizes["fq_words"],
                               rec.sizes["pairing_lanes"])
    return roofline_pct(len(busy) * least_s(nbytes, ops), sum(busy))
