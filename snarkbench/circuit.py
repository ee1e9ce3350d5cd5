"""The one circuit generator: a satisfiable R1CS of a configuration's
stated shape, made from the seed, and its witnesses.

A configuration (configs/<name>.json) gives the constraint count, the
public inputs and their widths, and the mix of row kinds under "rows",
each a share of the private rows.  Every row allocates one signal, as a
bellman or circom gadget allocates one variable a constraint:

    bool    (1 - b) * b = 0                     a free bit b
    xor     (2 a) * b = a + b - c               c = a ^ b, of earlier bits
    and     a * b = c                           c = a & b
    lookup  (k0 + k1 b0 + k2 b1 + k3 b2) * (1 - 2 b3) = y
                                                a windowed table lookup:
                                                full-width y from bits
    mul     (x1 + x2) * (x3 + k x4) = z         full-width z from earlier
                                                full-width signals

then one row a public input: a bit-width input packs that many earlier
bits, (sum 2^i b_i) * 1 = x; a full-width one equals an earlier
full-width signal, z * 1 = x.  Operands come from the last `operand_window`
signals of their kind.  The row counts are the same for every seed; the
seed draws the order, the operands and the constants.

Signals: 0 is ONE, 1..n_public the public inputs, then one a private
row, in row order."""

from __future__ import annotations

import dataclasses
import random

KINDS = ("bool", "xor", "and", "lookup", "mul")
# the first rows, which give the later rows operands of both kinds
_PREFIX = (("bool", 16), ("lookup", 4))


@dataclasses.dataclass
class Circuit:
    constraints: list     # [(A, B, C)] dicts {signal: coefficient mod r}
    n_signals: int
    n_public: int
    rows: list            # (kind, out, operands, constants) to evaluate
    r: int


def row_counts(cfg: dict) -> dict:
    """Private rows of each kind: the configuration's shares of the
    constraints that are not public-input rows, the remainder to bool."""
    n = cfg["constraints"] - len(cfg["public_inputs"])
    counts = {k: int(round(cfg["rows"].get(k, 0.0) * n)) for k in KINDS}
    counts["bool"] += n - sum(counts.values())
    for kind, k in _PREFIX:
        if counts[kind] < k:
            raise ValueError(f"{cfg['name']}: fewer than {k} {kind} rows")
    return counts


def generate(cfg: dict, seed: int, r: int) -> Circuit:
    rng = random.Random(seed)
    counts = row_counts(cfg)
    order = []
    for kind, k in _PREFIX:
        order += [kind] * k
        counts[kind] -= k
    rest = [kind for kind in KINDS for _ in range(counts[kind])]
    rng.shuffle(rest)
    order += rest
    pubs = cfg["public_inputs"]
    win = cfg["operand_window"]
    first = 1 + len(pubs)
    bits, wide = [], []          # signals of each kind, in order
    cons, rows = [], []

    def pick(pool, k):
        tail = pool[-win:]
        return [tail[rng.randrange(len(tail))] for _ in range(k)]

    for j, kind in enumerate(order):
        out = first + j
        if kind == "bool":
            cons.append(({0: 1, out: r - 1}, {out: 1}, {}))
            rows.append((kind, out, (), ()))
        elif kind in ("xor", "and"):
            a, b = pick(bits, 2)
            if kind == "xor":
                cons.append(({a: 2}, {b: 1},
                             _lc([(a, 1), (b, 1), (out, r - 1)], r)))
            else:
                cons.append(({a: 1}, {b: 1}, {out: 1}))
            rows.append((kind, out, (a, b), ()))
        elif kind == "lookup":
            ops = pick(bits, 4)
            ks = [rng.randrange(1, r) for _ in range(4)]
            cons.append((_lc([(0, ks[0]), (ops[0], ks[1]), (ops[1], ks[2]),
                              (ops[2], ks[3])], r),
                         _lc([(0, 1), (ops[3], r - 2)], r), {out: 1}))
            rows.append((kind, out, tuple(ops), tuple(ks)))
        else:
            ops = pick(wide, 4)
            k = rng.randrange(1, r)
            cons.append((_lc([(ops[0], 1), (ops[1], 1)], r),
                         _lc([(ops[2], 1), (ops[3], k)], r), {out: 1}))
            rows.append((kind, out, tuple(ops), (k,)))
        (bits if kind in ("bool", "xor", "and") else wide).append(out)

    for i, p in enumerate(pubs, start=1):
        if p["bits"] is None:
            z, = pick(wide, 1)
            cons.append(({z: 1}, {0: 1}, {i: 1}))
            rows.append(("copy", i, (z,), ()))
        else:
            if p["bits"] > len(bits):
                raise ValueError(f"{cfg['name']}: too few bits to pack")
            src = bits[-p["bits"]:]
            bits = bits[:-p["bits"]]
            cons.append((_lc([(b, 1 << k) for k, b in enumerate(src)], r),
                         {0: 1}, {i: 1}))
            rows.append(("pack", i, tuple(src), ()))
    return Circuit(cons, first + len(order), len(pubs), rows, r)


def _lc(terms, r: int) -> dict:
    """A linear combination from (signal, coefficient) terms, repeated
    signals merged, zeros dropped."""
    out = {}
    for s, v in terms:
        out[s] = (out.get(s, 0) + v) % r
    return {s: v for s, v in out.items() if v}


def witness(circ: Circuit, rng: random.Random) -> list:
    """A satisfying assignment: free bits drawn from rng, every other
    signal worked out row by row."""
    r = circ.r
    w = [0] * circ.n_signals
    w[0] = 1
    getbits = rng.getrandbits
    for kind, out, ops, ks in circ.rows:
        if kind == "bool":
            w[out] = getbits(1)
        elif kind == "xor":
            w[out] = w[ops[0]] ^ w[ops[1]]
        elif kind == "and":
            w[out] = w[ops[0]] & w[ops[1]]
        elif kind == "lookup":
            x = (ks[0] + ks[1] * w[ops[0]] + ks[2] * w[ops[1]]
                 + ks[3] * w[ops[2]])
            w[out] = (r - x) % r if w[ops[3]] else x % r
        elif kind == "mul":
            w[out] = (w[ops[0]] + w[ops[1]]) * (w[ops[2]] + ks[0]
                                                * w[ops[3]]) % r
        elif kind == "copy":
            w[out] = w[ops[0]]
        else:
            w[out] = sum(w[b] << k for k, b in enumerate(ops)) % r
    return w


def satisfied(circ: Circuit, w) -> bool:
    r = circ.r

    def ev(lc):
        return sum(v * w[s] for s, v in lc.items()) % r

    return all(ev(A) * ev(B) % r == ev(C) for A, B, C in circ.constraints)
