"""MNT6753 batched Pedersen hash and deterministic group map on the device,
PyTorch port of wasmsnark_tpu/models/mnt6753_device.py.

The reference hashes one proof at a time in a worker (PEDERSEN_HASH,
src/mnt6753.js:251-263), then runs blake2s and mnt6753_groupMap.  Here N
proofs' bit strings hash in lanes: each of the 2,010 3-bit windows picks
its signed multiple of its base from a per-window affine table, the 11
chunks of 188 windows fold into a [188, N] accumulator grid with 10 batched
complete adds, and a 187-step fold (4 doublings and an add per step) gives
the hash point.  The group map evaluates its three candidate x values
branch-free with masked selects (build_mnt6753.js:1385-1511, including
f1m_sqrt's even-root convention).  blake2s stays on the host, as in the
reference.  Everything composes the field ops (K1/K2 on the card) and the
projective group law of ops/curve.py; nothing here has a kernel of its own,
as in the JAX package.
"""

from __future__ import annotations

import functools

import torch

from ..ops.curve import ProjectiveDevice, map_leaf
from ..ops.fp import FpDevice, FpSqrt, planes, resolve_device
from ..ops.towers import FpAdapter, stack, unstack
from .mnt6753 import mnt6753, Q, A, B as CURVE_B
from .mnt6753_constants import (
    GROUP_MAP_CONIC_C, GROUP_MAP_PROJ_Z, PEDERSEN_CHUNK_SIZE)

# bits the verifier hashes: two G1 points (1 + 753 bits each) and two G2
# points over F3 (1 + 3 * 753 bits each), in 2,010 windows of 3 bits
# (mnt6753.js:645-658)
VERIFIER_BITS = 2 * (1 + 753) + 2 * (1 + 3 * 753)


class Mnt6753Device:
    """The Pedersen hash and group map of one device."""

    def __init__(self, device=None):
        self.m = mnt6753()
        self.fp = FpDevice(self.m.fp_spec, device)
        self.device = self.fp.device
        self.sq = FpSqrt(self.fp)
        a_mont = self.fp.pack_mont([A])
        self.G1d = ProjectiveDevice(FpAdapter(self.fp),
                                    lambda z: self.fp.mont_mul(z, a_mont))

    def _const(self, v):
        return self.fp.pack_mont([v])

    # -- group map (build_mnt6753.js:1385-1511, branch-free) -------------------

    def group_map(self, t):
        """t: [L, *B] canonical limb planes -> (x, y, z) projective G1 planes
        (Montgomery form, z = 1), the point of Mnt6753.group_map per lane.

        With s = 2 N1 / D1 (N1 = ct + projz, D1 = ct t + 1) the reference's
        two chained inversions decouple: z = (projz D1 - 2 N1) / D1 and
        y = (D1 - 2 N1 t) / D1, so v = z / y - 1/2 needs the inverse of
        D1 - 2 N1 t and y that of D1, both from one batch_inv (assuming
        D1 != 0, as the reference does)."""
        F = self.fp
        tm = F.to_mont(planes(t, self.device))

        def const(v):       # a constant broadcast to tm's shape
            return self._const(v).reshape(
                (F.L,) + (1,) * (tm.dim() - 1)).expand(tm.shape)

        one, half, projz = const(1), const(pow(2, -1, Q)), \
            const(GROUP_MAP_PROJ_Z)
        ct = F.mont_mul(const(GROUP_MAP_CONIC_C), tm)
        d1 = F.add(F.mont_mul(ct, tm), one)
        n1 = F.add(ct, projz)
        two_n1 = F.add(n1, n1)
        n1t, pd1 = unstack(F.mont_mul(stack(two_n1, projz), stack(tm, d1)), 2)
        y_num = F.sub(d1, n1t)
        z_num = F.sub(pd1, two_n1)
        inv_ynum, inv_d1 = F.batch_inv([y_num, d1])
        zy, y = unstack(F.mont_mul(stack(z_num, y_num),
                                   stack(inv_ynum, inv_d1)), 2)
        v = F.sub(zy, half)
        x1, x2, x3 = v, F.neg(F.add(one, v)), F.add(one, F.mont_sqr(y))
        xs = stack(x1, x2, x3)
        x_sq, ax = unstack(F.mont_mul(stack(xs, stack(*[const(A)] * 3)),
                                      stack(xs, xs)), 2)
        rhs = F.add(F.add(F.mont_mul(x_sq, xs), ax),
                    stack(*[const(CURVE_B)] * 3))
        y1, y2, y3 = unstack(rhs, 3)
        # one Euler ladder for the first two candidates; the first with a
        # square right-hand side wins, in the reference's order
        m1, m2 = self.sq.is_square(stack(y1, y2)).unbind(0)
        x = F.select(m1, x1, F.select(m2, x2, x3))
        ysq = F.select(m1, y1, F.select(m2, y2, y3))
        return (x, self.sq.sqrt(ysq), F.one_mont(*x.shape[1:]))

    # -- Pedersen hash (build_pedersenhash.js, batched) -------------------------

    @functools.cached_property
    def _window_tables(self):
        """Per-window {1B, 2B, 3B, 4B} affine tables (Montgomery planes)
        for the verifier's 2,010 windows: (tx, ty), each [L, n_win, 4] on
        the device, the values of the JAX package's numpy tables."""
        m = self.m
        n = PEDERSEN_CHUNK_SIZE
        n_win = (VERIFIER_BITS + 2) // 3
        rows = []                   # one row per base: the 4 affine points
        for base in m._pedersen_table[:(n_win + n - 1) // n]:
            rows.append([m.G1.affine(p) for p in base])
        idx = torch.arange(n_win, device=self.device) // n

        def plane(coord):
            vals = [p[coord] for row in rows for p in row]
            t = self.fp.pack_mont(vals).reshape(self.fp.L, len(rows), 4)
            return t[:, idx]

        return plane(0), plane(1)

    def pedersen_hash(self, bits):
        """bits: [nbits, B] 0/1 (tensor or numpy) -> canonical affine
        x-coordinate limb planes [L, B] (g1m_pedersenHash result)."""
        F, G = self.fp, self.G1d
        n = PEDERSEN_CHUNK_SIZE
        bits = torch.as_tensor(bits).to(device=self.device, dtype=torch.int64)
        nbits, Bn = bits.shape
        n_win = (nbits + 2) // 3
        bits = torch.cat([bits, bits.new_zeros((3 * n_win - nbits, Bn))])
        b3 = bits.reshape(n_win, 3, Bn)
        sel = b3[:, 0] | (b3[:, 1] << 1)                    # [n_win, B]
        tx, ty = self._window_tables
        if n_win > tx.shape[1]:
            raise ValueError("bit string longer than the window tables")
        idx = sel[None].expand(F.L, n_win, Bn)
        px = torch.gather(tx[:, :n_win], 2, idx)            # (sel+1)*Base
        py = torch.gather(ty[:, :n_win], 2, idx)
        py = F.select(b3[:, 2] != 0, F.neg(py), py)         # signed digit
        pz = F.one_mont(n_win, Bn)

        # accumulator k takes windows k, k + 188, ...; padded windows are
        # zero points (z = 0)
        n_chunks = (n_win + n - 1) // n
        padw = n_chunks * n - n_win

        def grid(a):
            a = torch.cat([a, a.new_zeros((F.L, padw, Bn))], dim=1)
            return a.reshape(F.L, n_chunks, n, Bn)

        px, py, pz = grid(px), grid(py), grid(pz)
        acc = (px[:, 0], py[:, 0], pz[:, 0])
        for c in range(1, n_chunks):
            acc = G.add(acc, (px[:, c], py[:, c], pz[:, c]))

        # res = acc[n-1]; for k = n-2 .. 0: res = 16 res + acc[k]
        res = map_leaf(acc, lambda a: a[:, n - 1])
        for k in range(n - 2, -1, -1):
            for _ in range(4):
                res = G.double(res)
            res = G.add(res, map_leaf(acc, lambda a: a[:, k]))

        x_aff = F.mont_mul(res[0], F.mont_inv(res[2]))
        return F.from_mont(x_aff)


@functools.lru_cache(maxsize=None)
def _device(device: str) -> Mnt6753Device:
    return Mnt6753Device(device)


def mnt6753_device(device=None) -> Mnt6753Device:
    """The MNT6753 hash and group map of `device` (default: the CUDA
    card), one per device."""
    return _device(str(resolve_device(device)))
