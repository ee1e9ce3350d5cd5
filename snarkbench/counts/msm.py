"""A multi-scalar multiplication's work, reckoned as a signed-digit
Pippenger at the window that minimises its operations: per window each
nonzero digit a mixed add into its bucket, the 2^(c-1) buckets summed as
a running sum (two adds a bucket), and the windows folded with c
doublings and an add each.  Scalars of one bit need one mixed add.  The
points are read once (affine), the scalars once."""

from . import elem_bytes
from .curve import jac_add, jac_dbl, jac_madd


def pippenger(n: int, bits: int, w: int, k: int = 1, fr_w: int = 8) -> tuple:
    """(operations, bytes) of an MSM of n points with scalars of `bits`
    bits (fr_w-word planes) over a base field of w words and extension
    degree k."""
    madd, add, dbl = (f(w, k)[0] for f in (jac_madd, jac_add, jac_dbl))
    if bits <= 1:
        ops = n * madd
    else:
        ops = min(
            -(-(bits + 1) // c) * (n * madd + 2 * (1 << (c - 1)) * add
                                   + c * dbl + add)
            for c in range(2, 21))
    nbytes = n * (2 * k * elem_bytes(w) + elem_bytes(fr_w))
    return ops, nbytes


def msm_mix(n_wide: int, n_bits: int, bits: int, w: int, k: int = 1) -> tuple:
    """An MSM whose scalars are n_wide of `bits` bits and n_bits of one
    bit (a witness of bits and field elements)."""
    a, b = pippenger(n_wide, bits, w, k), pippenger(n_bits, 1, w, k)
    return a[0] + b[0], a[1] + b[1]
