"""The work of a batch of MNT6753 Bowe-Gabizon verifications, lane by
lane, reckoned from the curve's parameters alone: one product of five ate
pairings from prepared line coefficients (the loop's doubling steps square
the accumulator, every step evaluates each pair's line at its G1 point and
multiplies it in) and one final exponentiation (q^3 - 1)(q + 1)(q + w0),
the last chunk a ladder over w0's bits.  Counts are in products and adds
of the 753-bit field Fp (F6 = F3[w] over F3 = Fp[v]), at the fewest the
usual formulas need, so that the least time stays a lower bound; the
ladders that prepare the coefficients are not counted."""

from . import add, elem_bytes, mm

# the ate loop count (src/mnt6753/build_mnt6753.js:262), which is also the
# final exponentiation's w0
LOOP = 204691208819330962009469868104636132783269696790011977400223898462431810102935615891307667367766898917669754470400
PAIRS = 5

# Fp (products, adds) of each step
F3_MUL = (6, 15)          # Karatsuba; a product by the non-residue an add
F3_SQR = (5, 12)          # Chung-Hasan
F6_MUL = (3 * F3_MUL[0], 3 * F3_MUL[1] + 15)
F6_SQR = (2 * F3_MUL[0], 2 * F3_MUL[1] + 12)
F6_CYC_SQR = (F3_SQR[0] + F3_MUL[0], F3_SQR[1] + F3_MUL[1] + 12)
LINE_EVAL = (6, 3)        # two F3 coefficients times P's x and y
LINE_MUL = (15, 30)       # f times a line a + b w with a in Fp
F6_INV = (27, 36)         # besides one Fp inverse
FROBENIUS = (5, 0)


def doublings() -> int:
    return LOOP.bit_length() - 1


def additions() -> int:
    return bin(LOOP).count("1") - 1


def _ops(w: int, steps) -> int:
    return sum(n * (p * mm(w) + a * add(w)) for n, (p, a) in steps)


def miller_steps(pairs: int = PAIRS) -> list:
    """(count, step) of a lane's product of `pairs` Miller loops."""
    steps = doublings() + additions()
    return [(doublings(), F6_SQR), (steps * pairs, LINE_EVAL),
            (steps * pairs, LINE_MUL)]


def final_exp_steps() -> list:
    """(count, step) of the final exponentiation: conj(f) / f, its
    Frobenius times it, then frob(t) t^w0."""
    return [(1, F6_INV), (3 + additions(), F6_MUL), (2, FROBENIUS),
            (doublings(), F6_CYC_SQR)]


def pairing_lane(w: int, pairs: int = PAIRS) -> int:
    """Operations of one lane's product of `pairs` pairings and its final
    exponentiation; the base-field inverse as a Fermat power."""
    inverse = (w * 32) * mm(w)
    return _ops(w, miller_steps(pairs)) + _ops(w, final_exp_steps()) \
        + inverse


def verify_batch(w: int, lanes: int) -> tuple:
    """(operations, bytes) of a batch's five-pair products: per lane its
    five G1 points, the line coefficients of its own two G2 points (three
    F3 values a step), its expected F6 value read and one F6 value
    written; the key's two G2 points' coefficients read once."""
    steps = doublings() + additions()
    coeffs = steps * 3 * 3
    lane_elems = PAIRS * 2 + 2 * coeffs + 6 + 6
    return lanes * pairing_lane(w), (lanes * lane_elems + 2 * coeffs) \
        * elem_bytes(w)
