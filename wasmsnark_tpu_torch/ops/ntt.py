"""Radix-2 NTT over a prime field, PyTorch port of wasmsnark_tpu/ops/ntt.py
(NTTDevice: plan, fft, ifft) — the semantics of the reference's
build_fft.js.

The transform is the JAX package's: a bit-reverse permutation, then stage
s = 1..bits pairs lane u = g*2h + j with u + h (h = 2^(s-1)) and
multiplies by twiddle j; an inverse mirrors i <-> N - i and scales by 1/N.
On the card it runs as a few launches of K3 (`ntt_pass`,
csrc/fp_kernels.cu), each a pass of up to TILE_LOG stages in shared memory
(`ntt_passes`): the first pass loads through the bit-reverse, an
inverse's last pass stores through the mirror and the scale.  `odd=True`
evaluates at the odd powers of the 2N-th root (stage-s twiddles start at
roots[s+1]), which is how CALC_H evaluates on a 2N domain with two N-point
transforms.  All values are in Montgomery form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields.spec import FieldSpec, NTTSpec
from ..utils.serialize import ints_to_limbs_fast
from . import cuda_lib
from .fp import (FpDevice, check_cuda, mod_add_plain, mod_sub_plain,
                 mont_mul_plain, planes)

# log2 of the most elements a tile of K3's pass holds (csrc/fp_kernels.cu
# kNttTileLog): the stages a pass can run
TILE_LOG = 10
# a pass after the first keeps at least 2^COLS_LOG columns a tile: 16-byte
# runs of each limb plane
COLS_LOG = 2
# a transform of fewer than 2^(TILE_LOG + MIN_TILES_LOG) points takes
# tiles of half the size, so that each pass has at least 2^MIN_TILES_LOG
# tiles (blocks) for the card's 132 SMs
MIN_TILES_LOG = 7


def ntt_passes(bits: int) -> list:
    """(s0, s1, tile_log) of each K3 launch of a 2^bits transform: stages
    s0..s1-1 (stage s of half-width 2^s) on tiles of 2^tile_log elements.
    Up to 2^TILE_LOG points one pass; above, a first pass of tile_log
    stages and then as few passes as leave 2^COLS_LOG columns a tile,
    their stages shared out evenly: 2^16 (512-element tiles) and 2^17
    (1,024) two passes, 2^21 three."""
    if bits <= TILE_LOG:
        return [(0, bits, bits)]
    t = TILE_LOG if bits >= TILE_LOG + MIN_TILES_LOG else TILE_LOG - 1
    out = [(0, t, t)]
    passes = -(-(bits - t) // (t - COLS_LOG))
    for k in range(passes, 0, -1):
        s = out[-1][1]
        out.append((s, s + -(-(bits - s) // k), t))
    return out


@functools.lru_cache(maxsize=32)
def _bitrev(bits: int) -> np.ndarray:
    idx = np.arange(1 << bits)
    rev = np.zeros(1 << bits, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def butterfly_plain(spec: FieldSpec, x, tw):
    """One stage on [L, n] planes with twiddles [L, h]: the JAX package's
    reshape to [L, groups, 2, h], (u + v*w, u - v*w)."""
    L, n = x.shape
    h = tw.shape[1]
    xv = x.reshape(L, n // (2 * h), 2, h)
    u = xv[:, :, 0, :].reshape(L, -1)
    v = xv[:, :, 1, :].reshape(L, -1)
    w = tw[:, None, :].expand(L, n // (2 * h), h).reshape(L, -1)
    t = mont_mul_plain(spec, v, w)
    x0 = mod_add_plain(spec, u, t).reshape(L, -1, 1, h)
    x1 = mod_sub_plain(spec, u, t).reshape(L, -1, 1, h)
    return torch.cat([x0, x1], dim=2).reshape(L, n)


def butterfly(spec: FieldSpec, x, tw):
    """K3 over one stage of any width h dividing n/2 (replaces fp_pallas.py
    butterfly_pallas)."""
    L, n = x.shape
    h = tw.shape[1]
    if n % (2 * h):
        raise ValueError("stage width must divide the domain")
    if not x.is_cuda:
        return butterfly_plain(spec, x, tw)
    x = x.contiguous()
    tw = tw.contiguous()
    check_cuda(x, tw)
    out = torch.empty_like(x)
    cuda_lib.launch("k3_butterfly", spec, (x, tw, out), (n, h))
    return out


def ntt_pass_plain(spec: FieldSpec, x, tw, s0: int, s1: int,
                   gather: bool = False, invn=None):
    """Stages s0..s1-1 of a transform of [L, n] planes, n = 2^bits, with
    its concatenated twiddle table tw [L, n - 1] (stage s's 2^s entries
    from column 2^s - 1): with `gather` the input taken bit-reversed first,
    with `invn` ([L, 1] planes) the output mirrored, i <-> (n - i) mod n,
    and multiplied by it."""
    n = x.shape[1]
    bits = n.bit_length() - 1
    if gather:
        x = torch.index_select(x, 1, torch.from_numpy(_bitrev(bits)).to(
            x.device))
    for s in range(s0, s1):
        h = 1 << s
        x = butterfly_plain(spec, x, tw[:, h - 1:2 * h - 1])
    if invn is not None:
        mirror = (-torch.arange(n, device=x.device)) % n
        x = torch.index_select(x, 1, mirror)
        x = mont_mul_plain(spec, x, invn.expand_as(x))
    return x


def ntt_pass(spec: FieldSpec, x, tw, s0: int, s1: int, gather: bool = False,
             invn=None, out=None, tile_log: int = TILE_LOG):
    """K3: one pass, stages s0..s1-1 in one launch on tiles of up to
    2^tile_log elements (ntt_pass_plain's semantics; s1 - s0 <= tile_log
    <= TILE_LOG).  `out` may be x itself where the pass neither gathers
    nor mirrors: a tile reads all of its elements before it writes them."""
    if not x.is_cuda:
        return ntt_pass_plain(spec, x, tw, s0, s1, gather, invn)
    x = x.contiguous()
    L, n = x.shape
    if n & (n - 1) or tw.shape[1] != n - 1:
        raise ValueError("ntt_pass takes a power-of-two domain and its "
                         "[L, n - 1] twiddle table")
    scale = tw if invn is None else invn
    if out is None:
        out = torch.empty_like(x)
    elif out.data_ptr() == x.data_ptr() and (gather or invn is not None):
        raise ValueError("a pass that gathers or mirrors cannot run in place")
    check_cuda(x, tw, scale, out)
    cuda_lib.launch("k3_ntt_pass", spec, (x, tw, scale, out),
                    (n, s0, s1, int(gather) | (invn is not None) << 1,
                     tile_log))
    return out


class NTTDevice:
    def __init__(self, ntt_spec: NTTSpec, fp: FpDevice):
        self.spec = ntt_spec
        self.field = ntt_spec.field
        self.F = fp
        self._plans: dict = {}

    def _twiddles(self, bits: int, odd: bool):
        """The stages' twiddles, stage s's 2^(s-1) at column 2^(s-1) - 1 of
        [L, 2^bits - 1] planes, Montgomery form."""
        q, R = self.field.q, self.field.R
        roots = self.spec.roots
        vals = []
        for s in range(1, bits + 1):
            w = roots[s]
            cur = roots[s + 1] if odd else 1
            for _ in range(1 << (s - 1)):
                vals.append(cur * R % q)
                cur = cur * w % q
        return planes(ints_to_limbs_fast(vals, self.field.n_limbs).reshape(
            self.field.n_limbs, len(vals)), self.F.device)

    def plan(self, bits: int, odd: bool = False, inverse: bool = False):
        """Tables for one transform, on the device, cached per shape."""
        key = (bits, odd, inverse)
        p = self._plans.get(key)
        if p is None:
            # an inverse shares the forward transform's table
            p = {"tw": self.plan(bits, odd)["tw"] if inverse
                 else self._twiddles(bits, odd)}
            if inverse:
                v = self.spec.inv2[bits] * self.field.R % self.field.q
                p["invn"] = planes(ints_to_limbs_fast(
                    [v], self.field.n_limbs), self.F.device)
            self._plans[key] = p
        return p

    def rank_plan(self, bits: int, d: int, index: int, odd: bool = False,
                  inverse: bool = False, strided: bool = True):
        """The twiddle plane of rank `index` of 2^d in a transform of 2^bits
        points split over the ranks (parallel/mesh.py ShardedNTT), [L,
        2^(bits-d)] Montgomery planes on the device, or None where every
        entry is one.  With N = 2^bits, D = 2^d, M = N / D, c = w_2N if odd
        else 1, w = w_N^-1 if inverse else w_N and s = 1/D if inverse else
        1 (the local transforms' 1/M makes the 1/N), entry

          strided=True:  k -> c^index w^(index k) s;
          strided=False: ml*D + t -> w^(m k1) s, m = index*M/D + ml,
                         k1 = -t mod D: an inverse without coset only (its
                         D-point DFTs run forward, their outputs mirrored).

        The first sits between the local M-point transforms and the
        D-point DFTs (the input strided), the second between the D-point
        DFTs and the local transforms (the input in chunks).  Cached per
        (bits, d, index, odd, inverse, strided)."""
        if not strided and (odd or not inverse):
            raise ValueError("a plane for the input in chunks is an "
                             "inverse's without coset")
        key = ("rank", bits, d, index, odd, inverse, strided)
        if key in self._plans:
            return self._plans[key]
        if d == 0:                                  # one rank: all ones
            return None
        q, R = self.field.q, self.field.R
        D, M = 1 << d, 1 << (bits - d)
        w = self.spec.roots[bits]
        if inverse:
            w = pow(w, q - 2, q)
        c = self.spec.roots[bits + 1] if odd else 1
        s = pow(D, q - 2, q) if inverse else 1
        if strided:
            step = pow(w, index, q)
            cur = pow(c, index, q) * s % q
            vals = []
            for _ in range(M):
                vals.append(cur)
                cur = cur * step % q
        else:
            per = M // D
            cols = []
            for t in range(D):
                step = pow(w, (-t) % D, q)
                cur = pow(step, index * per, q) * s % q
                col = []
                for _ in range(per):
                    col.append(cur)
                    cur = cur * step % q
                cols.append(col)
            vals = [v for row in zip(*cols) for v in row]
        p = None
        if any(v != 1 for v in vals):
            p = planes(ints_to_limbs_fast([v * R % q for v in vals],
                                          self.field.n_limbs), self.F.device)
        self._plans[key] = p
        return p

    def _transform(self, x, tw, invn):
        """The passes of ntt_passes over x [L, 2^bits]: the first gathers,
        the last mirrors and scales where invn is given; passes between
        run in place."""
        n = x.shape[1]
        passes = ntt_passes(n.bit_length() - 1)
        for k, (s0, s1, tile_log) in enumerate(passes):
            last = k == len(passes) - 1
            x = ntt_pass(self.field, x, tw, s0, s1, gather=k == 0,
                         invn=invn if last else None,
                         out=None if k == 0 or last and invn is not None
                         else x, tile_log=tile_log)
        return x

    def fft(self, x, odd: bool = False, plan=None):
        """In-order DFT of Montgomery coefficients x [L, N]."""
        L, n = x.shape
        bits = n.bit_length() - 1
        if 1 << bits != n or bits > self.spec.max_bits:
            raise ValueError("size must be a power of two within the field's "
                             "2-adicity")
        if plan is None:
            plan = self.plan(bits, odd)
        return self._transform(x, plan["tw"], None)

    def ifft(self, x, odd: bool = False, plan=None):
        """Inverse DFT: fft, mirror i <-> N - i, scale by 1/N."""
        L, n = x.shape
        bits = n.bit_length() - 1
        if 1 << bits != n or bits > self.spec.max_bits:
            raise ValueError("size must be a power of two within the field's "
                             "2-adicity")
        if plan is None:
            plan = self.plan(bits, odd, inverse=True)
        return self._transform(x, plan["tw"], plan["invn"])

    # -- vector helpers (build_fft.js:374-547) ---------------------------------

    def mul_n(self, a, b):
        return self.F.mont_mul(a, b)

    def to_mont_n(self, a):
        return self.F.to_mont(a)

    def from_mont_n(self, a):
        return self.F.from_mont(a)


def serialize_limbs(vals, n_limbs) -> np.ndarray:
    """ints -> uint32 [n_limbs, len(vals)] 16-bit limb planes."""
    return ints_to_limbs_fast(vals, n_limbs)
