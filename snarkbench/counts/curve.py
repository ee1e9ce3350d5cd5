"""Group-law operations and bytes a lane (chip_smoke.py's k5_ops, k6_ops
and k7_ops at a general lane: operands nonzero and distinct, Z1 not one),
over a base field of w words and its degree-k extension (k = 2 for G2,
an F2 product counted as 3 base products and 5 adds, an F2 add as 2)."""

from . import add, elem_bytes, mm


def _ext(w: int, k: int, prods: int, adds: int) -> int:
    if k == 1:
        return prods * mm(w) + adds * add(w)
    return prods * (3 * mm(w) + 5 * add(w)) + adds * 2 * add(w)


def jac_add(w: int, k: int = 1) -> tuple:
    """(operations, bytes) of one Jacobian add: 16 products, 11 adds;
    two points read, one written."""
    return _ext(w, k, 16, 11), 9 * k * elem_bytes(w)


def jac_madd(w: int, k: int = 1) -> tuple:
    """A mixed add of an affine point into a Jacobian one: 11 products,
    11 adds; 5 elements read, 3 written."""
    return _ext(w, k, 11, 11), 8 * k * elem_bytes(w)


def jac_dbl(w: int, k: int = 1) -> tuple:
    """One doubling: 7 products, 11 adds; one point read and written."""
    return _ext(w, k, 7, 11), 6 * k * elem_bytes(w)
