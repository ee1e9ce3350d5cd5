"""NTT and CALC_H work (chip_smoke.py's ntt_ops and ntt_bytes)."""

from . import add, elem_bytes, mm


def ntt(w: int, n: int, inverse: bool) -> tuple:
    """(operations, bytes) of an n-point transform: n/2 butterflies a
    stage (a product, an add and a sub) and an inverse's n products by
    1/N; its planes read and written once, its n - 1 twiddles (and an
    inverse's 1/N) read once."""
    bits = n.bit_length() - 1
    ops = (n // 2) * bits * (mm(w) + 2 * add(w)) + (n * mm(w) if inverse
                                                     else 0)
    return ops, (3 * n - 1 + int(inverse)) * elem_bytes(w)


def calc_h(w: int, n: int, nnz: int, n_signals: int) -> tuple:
    """CALC_H over a domain of n points from nnz QAP entries: the two
    linear combinations (a product and an add an entry, the signals and
    the entries' coefficients read), two inverse and two odd-coset
    transforms of n points, the 2n-point product and one 2n-point inverse
    transform, H's n coefficients written."""
    parts = [ntt(w, n, True), ntt(w, n, True), ntt(w, n, False),
             ntt(w, n, False), ntt(w, 2 * n, True)]
    ops = sum(p[0] for p in parts) + nnz * (mm(w) + add(w)) \
        + 2 * n * mm(w)
    nbytes = sum(p[1] for p in parts) + (nnz + n_signals + n) \
        * elem_bytes(w)
    return ops, nbytes
