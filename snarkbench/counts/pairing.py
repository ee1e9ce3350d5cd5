"""The work of a batch of Groth16 verification equations, lane by lane,
reckoned from the curve's parameters alone: four optimal-ate Miller
loops sharing one accumulator (three pairs' G2 lines prepared once for
the key and shared by every lane, the proof's B doubled and added along
the loop) and one final exponentiation.  Counts are in F2 products and
adds of the tower F12 = F2[v, w] (an F2 product 3 base products and 5
adds), at the fewest the usual formulas need: the least time stays a
lower bound.  A curve of another family brings its counts in a file of
its own."""

from . import add, elem_bytes, mm

# |loop|, its set bits (the ate loop 6x + 2 for BN128, |x| for BLS12-381),
# and the final exponentiation's hard part as exponentiations by |x|
CURVES = {"bn128": {"loop": 29793968203157093288, "x": 4965661367192848881,
                    "x_exps": 3, "frobenius_steps": 2, "hard_muls": 12},
          "bls12381": {"loop": 15132376222941642752,
                       "x": 15132376222941642752, "x_exps": 5,
                       "frobenius_steps": 0, "hard_muls": 8}}

# F2 (products, adds) of each step
F12_MUL = (18, 40)
F12_SQR = (12, 30)
F12_CYC_SQR = (9, 24)
LINE_MUL = (13, 25)          # the sparse product by a line
LINE_EVAL = (2, 0)           # the line's coefficients times P's x and y
G2_DBL_LINE = (9, 15)        # a G2 doubling and its line's coefficients
G2_ADD_LINE = (13, 8)
F12_INV = (40, 30)           # besides one base-field inverse
FROBENIUS = (10, 0)


def _ops(w: int, steps) -> int:
    prods = sum(n * p for n, (p, _) in steps)
    adds = sum(n * a for n, (_, a) in steps)
    return prods * (3 * mm(w) + 5 * add(w)) + adds * 2 * add(w)


def pairing_lane(curve: str, w: int, pairs: int = 4) -> int:
    """Operations of one lane's product of `pairs` pairings, one of them
    with an unprepared G2 point."""
    c = CURVES[curve]
    dbl = c["loop"].bit_length() - 1
    adds = bin(c["loop"]).count("1") - 1 + c["frobenius_steps"]
    xbits = c["x"].bit_length() - 1
    xw = bin(c["x"]).count("1") - 1
    miller = [(dbl, F12_SQR), (dbl * pairs + adds * pairs, LINE_MUL),
              (dbl * pairs + adds * pairs, LINE_EVAL), (dbl, G2_DBL_LINE),
              (adds, G2_ADD_LINE), (2 * c["frobenius_steps"], FROBENIUS)]
    final = [(1, F12_INV), (3, F12_MUL), (1, FROBENIUS),
             (c["x_exps"] * xbits, F12_CYC_SQR),
             (c["x_exps"] * xw + c["hard_muls"], F12_MUL), (3, FROBENIUS)]
    # the base-field inverse of F12_INV as a Fermat power
    inverse = (w * 32) * mm(w)
    return _ops(w, miller) + _ops(w, final) + inverse


def verify_batch(curve: str, w: int, lanes: int) -> tuple:
    """(operations, bytes) of a batch's pairings: per lane four G1 points
    and B read, one F12 value written."""
    nbytes = lanes * (4 * 2 + 4 + 12) * elem_bytes(w)
    return lanes * pairing_lane(curve, w), nbytes
