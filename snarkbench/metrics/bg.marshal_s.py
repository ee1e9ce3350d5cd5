"""The Bowe-Gabizon verifier's host marshalling: the bg.marshal span a
batch (parsing, affine points, vk_x, the rho ladders, alphaBeta^rho, the
hash's bit strings and the lanes' packing), median over the traced
batches."""
from snarkbench.program_spans import median_over_ops


def read(rec):
    return median_over_ops(rec, lambda o: o.seconds("bg.marshal"))
