"""Batched big-integer division and modular inversion on 16-bit limb
planes, PyTorch port of wasmsnark_tpu/ops/bigint.py (int_div, inverse_mod).

The reference's schoolbook long division (int_div, src/build_int.js:
710-924) and division-based extended Euclid (int_inverseMod, :926-1054)
branch per value.  Here, as in the JAX package, both are fixed-trip and
branch-free per lane:

  * ``int_div``: binary restoring division, one trip a dividend bit (shift
    a bit into the remainder, compare, conditionally subtract, record the
    quotient bit); every lane divides by its own divisor;
  * ``inverse_mod``: binary extended GCD for an odd modulus, 4 * nbits
    trips over L + 1 limbs, each halving an even u or v (the coefficient
    by the odd-modulus half-mod) or subtracting the smaller from the
    larger.

The JAX package's borrows lean on uint32 wraparound; here limbs are int64
and every carry and borrow chain is the carry lookahead of ops/fp.py with
an explicit 16-bit mask.  These are plain tensor code on any device: the
JAX package has no kernel here, and they are cold-path utilities (the
protocol paths use Fermat ladders and batch inversion, ops/fp.py).
"""

from __future__ import annotations

import torch

from ..fields.spec import LIMB_BITS, LIMB_MASK
from .fp import DTYPE, _lookahead, _sub_limbs

# inverse_mod's lanes are checked for completion every this many trips: a
# lane whose u reached 0 keeps its state, so stopping once every lane is
# done returns what the fixed trip count returns
_DONE_EVERY = 32


def _flat(x):
    return x.long().reshape(x.shape[0], -1)


def _add_limbs(x, y):
    """(x + y) mod 2^(16 L) over normalised int64 limbs [L, n]: a column
    is below 2^17, so its carry bit and its all-ones low limb never meet."""
    s = x + y
    lo = s & LIMB_MASK
    cin, _ = _lookahead(s >> LIMB_BITS, (lo == LIMB_MASK).long())
    return (lo + cin) & LIMB_MASK


def _shl1(x):
    """(x << 1) mod 2^(16 L)."""
    out = (x << 1) & LIMB_MASK
    out[1:] |= x[:-1] >> (LIMB_BITS - 1)
    return out


def _shr1(x):
    """x >> 1."""
    out = x >> 1
    out[:-1] |= (x[1:] & 1) << (LIMB_BITS - 1)
    return out


def _is_zero(x):
    return (x == 0).all(dim=0)


def _pad_to(x, L):
    if x.shape[0] >= L:
        return x
    return torch.cat([x, x.new_zeros((L - x.shape[0],) + x.shape[1:])])


def int_div(x, y):
    """Batched unsigned division: x [Lx, *B], y [Ly, *B] 16-bit limb planes
    -> (q [Lx, *B], r [Ly, *B]) with x = q y + r, 0 <= r < y, per lane.
    Lanes with y = 0 give q = 0 and r = x mod 2^(16 Ly) (defined behaviour
    in place of the reference's undefined divide by zero)."""
    Lx, Ly = x.shape[0], y.shape[0]
    bshape = x.shape[1:]
    xf, yf = _flat(x), _flat(y)
    # the remainder is one limb wider than y: after the shift-in it can
    # exceed y's width by a bit before the conditional subtract
    yw = _pad_to(yf, Ly + 1)
    y_zero = _is_zero(yf)
    r = xf.new_zeros((Ly + 1, xf.shape[1]))
    q_bits = []
    for k in range(Lx * LIMB_BITS - 1, -1, -1):
        li, off = divmod(k, LIMB_BITS)
        r = _shl1(r)
        r[0] |= (xf[li] >> off) & 1
        diff, borrow = _sub_limbs(r, yw)
        ge = (borrow == 0) & ~y_zero
        r = torch.where(ge[None], diff, r)
        q_bits.append(ge.long())
    # quotient bit k sits at q_bits[nbits - 1 - k]
    bits = torch.stack(q_bits[::-1]).reshape(Lx, LIMB_BITS, -1)
    weights = torch.arange(LIMB_BITS, device=bits.device)[None, :, None]
    q = (bits << weights).sum(1)
    return (q.to(DTYPE).reshape((Lx,) + bshape),
            r[:Ly].to(DTYPE).reshape((Ly,) + bshape))


def inverse_mod(x, m):
    """Batched modular inverse: x, m [L, *B] limb planes -> x^-1 mod m per
    lane ([Lm, *B]), for odd m.  Lanes where gcd(x, m) != 1 (x = 0
    included) give 0.  The invariants are x1 x = u and x2 x = v (mod m);
    each trip halves an even u or v (x1 or x2 by the half-mod: (t + m) / 2
    for odd t) or subtracts the smaller from the larger, so 4 nbits trips
    over L + 1 limbs always suffice."""
    Lm = m.shape[0]
    bshape = x.shape[1:]
    L = max(x.shape[0], Lm) + 1       # + 1 limb: x1 + m before halving
    xw, mw = _pad_to(_flat(x), L), _pad_to(_flat(m), L)
    n = xw.shape[1]
    one = torch.zeros_like(xw)
    one[0] = 1
    u, v, x1, x2 = xw, mw, one, torch.zeros_like(xw)
    m2 = torch.cat([mw, mw], dim=1)
    for trip in range(4 * L * LIMB_BITS):
        if trip % _DONE_EVERY == 0 and bool(_is_zero(u).all()):
            break
        done = _is_zero(u)
        u_even = ((u[0] & 1) == 0) & ~done
        v_even = ((v[0] & 1) == 0) & ~done & ~u_even
        # u - v and v - u in one pass over both orders
        d, borrow = _sub_limbs(torch.cat([u, v], 1), torch.cat([v, u], 1))
        du, dv = d[:, :n], d[:, n:]
        u_ge_v = (borrow[:n] == 0) & ~done & ~u_even & ~v_even
        sub_v = ~done & ~u_even & ~v_even & ~u_ge_v
        # x1 / 2 and x2 / 2 mod m, x1 - x2 and x2 - x1 mod m
        t = torch.cat([x1, x2], 1)
        odd = ((t[0] & 1) == 1)[None]
        half = _shr1(torch.where(odd, _add_limbs(t, m2), t))
        sd, sb = _sub_limbs(t, torch.cat([x2, x1], 1))
        sd = torch.where((sb == 1)[None], _add_limbs(sd, m2), sd)
        u = torch.where(u_even[None], _shr1(u),
                        torch.where(u_ge_v[None], du, u))
        v = torch.where(v_even[None], _shr1(v),
                        torch.where(sub_v[None], dv, v))
        x1 = torch.where(u_even[None], half[:, :n],
                         torch.where(u_ge_v[None], sd[:, :n], x1))
        x2 = torch.where(v_even[None], half[:, n:],
                         torch.where(sub_v[None], sd[:, n:], x2))
    # u = 0 and v = gcd at the end; x2 = x^-1 (mod m) where gcd = 1
    ok = (v[0] == 1) & _is_zero(v[1:])
    inv = torch.where(ok[None], x2, torch.zeros_like(x2))
    return inv[:Lm].to(DTYPE).reshape((Lm,) + bshape)
