"""The Bowe-Gabizon verifier's scalar stage on the card: the bg.scalars
span a batch, under bg.marshal (the upload of the lanes' coordinates and
scalars, vk_x from the key's fixed-base tables, the rho ladder over A,
vk_x and C, their batched inversion, alphaBeta^rho from its table),
median over the traced batches; None where the program has no such
span."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("bg.scalars"))
