"""Batched fixed-base scalar multiplication and batch affine normalization,
PyTorch port of wasmsnark_tpu/ops/fixed_base.py (FixedBase,
batch_to_affine).

The trusted setup needs [k_i]G for every signal and domain point.  A small
host table T[w][d] = d * 2^(c*w) * G (c = 8: 256 entries per 8-bit window)
goes to the device once; each output point is the sum over windows of one
gathered table entry, a loop of complete mixed adds (K5 for G1) at full
batch width.  Results are normalized to affine Montgomery planes with one
batched Fermat inversion (K1 ladder), the pkey storage form.
"""

from __future__ import annotations

import torch

from ..fields.spec import LIMB_BITS
from .curve import map_leaf


class FixedBase:
    """curve_dev: JacobianDevice.  oracle_curve/generator: host group and
    base point for the window table.  pack_comp: list of canonical base-
    field coordinates -> Montgomery planes on the device (applied per tower
    component)."""

    def __init__(self, curve_dev, oracle_curve, generator, pack_comp,
                 scalar_bits: int, window_bits: int = 8):
        if LIMB_BITS % window_bits:
            raise ValueError("the window must divide the limb width")
        self.curve = curve_dev
        self.c = window_bits
        self.W = (scalar_bits + window_bits - 1) // window_bits
        C = oracle_curve
        base = generator
        flat = []
        for _ in range(self.W):
            acc = C.zero()
            flat.append(None)
            for _ in range((1 << window_bits) - 1):
                acc = C.add(acc, base)
                flat.append(None if C.is_zero(acc) else C.affine(acc))
            for _ in range(window_bits):
                base = C.double(base)
        zero = self._zero_coords(flat)
        xs = [p[0] if p else zero for p in flat]
        ys = [p[1] if p else zero for p in flat]
        D = 1 << window_bits
        # per tower component: [L, W*D] planes, entry w*D + d
        self.tx = map_leaf(self._transpose(xs), pack_comp)
        self.ty = map_leaf(self._transpose(ys), pack_comp)
        self.D = D

    @staticmethod
    def _zero_coords(flat):
        for p in flat:
            if p is not None:
                x = p[0]
                return map_leaf(x, lambda _: 0) if isinstance(x, tuple) else 0
        return 0

    @staticmethod
    def _transpose(vals):
        """list of (possibly nested-tuple) coords -> same nesting of lists
        (lists are leaves for map_leaf, which only descends into tuples)."""
        if isinstance(vals[0], tuple):
            return tuple(FixedBase._transpose([v[i] for v in vals])
                         for i in range(len(vals[0])))
        return list(vals)

    def _digits(self, scalar_limbs):
        c = self.c
        per = LIMB_BITS // c
        s = scalar_limbs.long()
        rows = []
        for w in range(self.W):
            li, sub = divmod(w, per)
            if li < s.shape[0]:
                rows.append((s[li] >> (c * sub)) & ((1 << c) - 1))
            else:
                rows.append(torch.zeros_like(s[0]))
        return torch.stack(rows, dim=0)              # [W, N]

    def points_jac(self, scalar_limbs):
        """scalar_limbs: [Ls, N] canonical 16-bit planes.  Returns Jacobian
        points, leaves [L, N] (Montgomery)."""
        C = self.curve
        d = self._digits(scalar_limbs)
        acc = None
        for w in range(self.W):
            idx = d[w] + w * self.D
            q = (map_leaf(self.tx, lambda a: torch.index_select(a, 1, idx)),
                 map_leaf(self.ty, lambda a: torch.index_select(a, 1, idx)))
            acc = C.promote(q) if acc is None else C.madd(acc, q)
        return acc

    def points_affine(self, scalar_limbs):
        """[k_i]G as affine Montgomery planes ((X, Y), zero = (0, 0))."""
        return batch_to_affine(self.curve, self.points_jac(scalar_limbs))


class FixedBaseSum:
    """start + sum_j [s_j] P_j on every lane, for fixed points start and
    P_1..P_k (a Groth16 key's IC[0] and IC[1..k]): one FixedBase table per
    base, side by side with the start point as a last column.  Every
    window's entry of every base and the start point are gathered at once,
    [L, N, M] with M = k W + 1 padded to a power of two by the zero entry,
    then summed by one level of mixed adds (K5 on a kernel-backed G1) and a
    tree of adds (K6): 1 + log2(M / 2) launches whatever the lanes.

    The tables are built per key at run time, on the host: 4-bit windows
    cost 15 host adds a window where 8-bit ones cost 255 (~0.3 s against
    ~2.5 s for 6 BN128 bases), for twice the entries a lane, which the
    card sums in microseconds."""

    WINDOW_BITS = 4

    def __init__(self, curve_dev, oracle_curve, start, bases, pack_comp,
                 scalar_bits: int):
        self.curve = curve_dev
        self.engines = [FixedBase(curve_dev, oracle_curve, p, pack_comp,
                                  scalar_bits, self.WINDOW_BITS)
                        for p in bases]
        self.W = -(-scalar_bits // self.WINDOW_BITS)
        self.D = 1 << self.WINDOW_BITS
        C = oracle_curve
        a = C.affine(start)
        if C.is_zero(start):
            a = (map_leaf(a[0], lambda _: 0),) * 2
        sx, sy = (map_leaf(FixedBase._transpose([c]), pack_comp)
                  for c in a[:2])
        # column (j W + w) D + d: base j's entry d of window w (d = 0 the
        # zero point); column k W D: the start point
        self.tx = _cat([e.tx for e in self.engines] + [sx])
        self.ty = _cat([e.ty for e in self.engines] + [sy])

    def points_jac(self, scalar_limbs):
        """scalar_limbs: [Ls, k, N] canonical 16-bit planes, s_j of lane n
        at [:, j, n].  Returns Jacobian points, leaves [L, N] (Montgomery)."""
        C = self.curve
        k, n = len(self.engines), scalar_limbs.shape[-1]
        dev = scalar_limbs.device
        m = k * self.W + 1
        M = 1 << (m - 1).bit_length()
        cols = []
        if k:
            d = self.engines[0]._digits(
                scalar_limbs.reshape(scalar_limbs.shape[0], k * n))
            d = d.reshape(self.W, k, n).permute(2, 1, 0).reshape(n, -1)
            cols.append(d + torch.arange(k * self.W, device=dev) * self.D)
        cols.append(torch.full((n, 1), k * self.W * self.D,
                               dtype=torch.long, device=dev))
        # the padding: column 0, base 0's zero entry
        cols.append(torch.zeros((n, M - m), dtype=torch.long, device=dev))
        idx = torch.cat(cols, dim=1).reshape(-1)
        q = map_leaf((self.tx, self.ty), lambda a: torch.index_select(
            a, 1, idx).reshape(a.shape[0], n, M))
        if M == 1:
            acc = C.promote(q)
        else:
            h = M // 2
            acc = C.madd(C.promote(map_leaf(q, lambda a: a[..., :h])),
                         map_leaf(q, lambda a: a[..., h:]))
            acc = C.tree_reduce(acc, h)
        return map_leaf(acc, lambda a: a.reshape(a.shape[0], n))


def _cat(parts):
    """Column-concatenate tables of the same tower nesting."""
    if isinstance(parts[0], tuple):
        return tuple(_cat([p[i] for p in parts])
                     for i in range(len(parts[0])))
    return torch.cat(parts, dim=1)


def batch_to_affine(curve_dev, p):
    """Jacobian -> affine Montgomery planes: one batched Fermat inversion
    over all lanes, then X/Z^2, Y/Z^3.  Zero points map to (0, 0)."""
    F = curve_dev.F
    X, Y, Z = p
    zero = curve_dev.is_zero(p)
    zi = F.inv(F.select(zero, F.one_like(Z), Z))
    zi2 = F.square(zi)
    ax = F.mul(X, zi2)
    ay = F.mul(Y, F.mul(zi, zi2))
    ax = F.select(zero, F.zero_like(ax), ax)
    ay = F.select(zero, F.zero_like(ay), ay)
    return (ax, ay)
