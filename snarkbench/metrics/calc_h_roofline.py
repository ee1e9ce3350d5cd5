"""CALC_H's least time (counts/ntt.py's calc_h, prove_work's "calc_h":
operations and bytes) over the device's busy time inside the
prove.calc_h spans placed on the trace's clock, over the traced proofs,
in %."""
from snarkbench.counts import least_s
from snarkbench.program_spans import busy_in, by_op
from snarkbench.readings import prove_work, roofline_pct


def read(rec):
    if rec.trace is None:
        return None
    busy = [b for b in (busy_in(rec.trace, o, "prove.calc_h")
                        for o in by_op(rec)) if b is not None]
    if not busy:
        return None
    ops, nbytes = prove_work(rec.sizes)["calc_h"]
    return roofline_pct(len(busy) * least_s(nbytes, ops), sum(busy))
