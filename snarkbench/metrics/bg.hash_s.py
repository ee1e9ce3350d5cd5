"""The Bowe-Gabizon verifier's hash: the bg.hash span a batch (the
Pedersen hash on the device, blake2s on the host and the digests'
upload), median over the traced batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("bg.hash"))
