"""The Bowe-Gabizon verifier's pairing: the bg.pairing span a batch (the
proofs' B and dp ladders, the key's prepared coefficients, the five-pair
product, the final exponentiation and the verdicts' copy to the host),
median over the traced batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("bg.pairing"))
