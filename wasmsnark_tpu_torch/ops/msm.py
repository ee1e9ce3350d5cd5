"""Multi-scalar multiplication, PyTorch port of wasmsnark_tpu/ops/msm.py
(window_digits, signed_window_digits, times_scalar_signed_device,
MSMDevice.msm / msm_point, fold_windows_device, fold_windows).

A bucketed Pippenger with signed c-bit digits, as in the JAX package, with
the TPU-only devices left out (row packing, the one-hot histogram, sublane
window grouping, lane tiles):

  * scalars recode to signed digits in [-2^(c-1), 2^(c-1)] (one extra
    window for the final carry); a negative digit adds (X, -Y), applied by
    K4 on the gathered Y planes;
  * a batch of K MSMs runs as one (the prover's four G1 sections): every
    (msm, window, point) entry with a nonzero digit is sorted by (msm,
    window, |digit|) — one torch.sort — and the affine points are gathered
    in that order;
  * a segmented scan over the sorted entries (ops/scan.py: first step the
    mixed add K5, then K6) leaves each bucket's sum at the end of its run;
  * the run ends fill a dense [K*W, 2^(c-1)] bucket array (empty buckets
    stay all-zero, which the complete add treats as the zero point), and
    the triangle sum_b b*S_b is a segmented suffix scan plus a halving
    reduction (K6);
  * fold_windows_device folds the windows MSB first: c doublings (one K7
    launch) and one add (K6) per window.

Completeness comes from the group law: repeated points, zero points,
inverse pairs, zero scalars and unreduced 256-bit scalars all fold in.

Spans (utils/spans.py): "msm" around msm_point, and inside it one a stage,
"msm.digits", "msm.sort" (nonzero, sort, gather), "msm.bucket_scan" (the
first seg_scan and the bucket fill), "msm.triangle" (the suffix seg_scan),
"msm.reduce" (reduce_last) and "msm.fold" (fold_windows_device).
"""

from __future__ import annotations

import torch

from ..fields.spec import LIMB_BITS
from .curve import map_leaf, map_leaf2
from .fp import planes
from .scan import seg_scan, reduce_last
from .towers import stack
from ..utils.spans import span


def window_digits(scalar_limbs, c: int):
    """[n_limbs, *B] 16-bit limbs -> [n_windows, *B] c-bit digits (int64),
    LSB window first; windows may straddle limb boundaries."""
    s = scalar_limbs.long()
    L = s.shape[0]
    if c == LIMB_BITS:
        return s
    n_win = (L * LIMB_BITS + c - 1) // c
    mask = (1 << c) - 1
    rows = []
    for w in range(n_win):
        li, off = divmod(c * w, LIMB_BITS)
        val = s[li] >> off
        if off + c > LIMB_BITS and li + 1 < L:
            val = val | (s[li + 1] << (LIMB_BITS - off))
        rows.append(val & mask)
    return torch.stack(rows, dim=0)


def signed_window_digits(scalar_limbs, c: int):
    """scalar = sum_w mag_w * (-1)^neg_w * 2^(c*w), mag in [0, 2^(c-1)].
    Returns (mag [W+1, *B] int64, neg [W+1, *B] bool)."""
    d = window_digits(scalar_limbs, c)
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(d[0])
    for w in range(d.shape[0]):
        t = d[w] + carry
        neg = t > half
        mags.append(torch.where(neg, full - t, t))
        negs.append(neg)
        carry = neg.long()
    mags.append(carry)
    negs.append(torch.zeros_like(negs[0]))
    return torch.stack(mags, dim=0), torch.stack(negs, dim=0)


def times_scalar_signed_device(curve, points, scalar_limbs,
                               window_bits: int = 4):
    """Batched signed-window scalar multiplication (the JAX package's
    times_scalar_signed_device, the NAF ladder of build_timesscalarnaf.js):
    every lane multiplies its point by its own scalar.  A table of the
    2^(c-1) + 1 multiples 0, P, .., 2^(c-1) P is built with adds (K6 on a
    kernel-backed G1); then per c-bit window, most significant first: the
    c doublings (one K7 launch there, `double_times`), the lane's multiple
    picked by one gather from the stacked table (the JAX package's K - 1
    masked selects are a TPU workaround), its sign (one K4 launch) and one
    add (K6).  Works over the Jacobian and projective devices alike.

    points: (X, Y, Z) leaves [.., *B]; scalar_limbs: [Ls, *B] canonical
    16-bit planes (numpy or a tensor)."""
    c = window_bits
    leaf = points[0]
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    mag, neg = signed_window_digits(planes(scalar_limbs, leaf.device), c)
    T = [curve.zero_like(points), points]
    for _ in range((1 << (c - 1)) - 1):
        T.append(curve.add(T[-1], points))
    table = stack(*T)                       # leaves [L, K, *B]

    def pick(w):
        def take(a):
            idx = mag[w].reshape((1, 1) + tuple(mag.shape[1:]))
            return torch.gather(a, 1, idx.expand(
                (a.shape[0], 1) + tuple(a.shape[2:])))[:, 0]
        return curve.cneg(neg[w], map_leaf(table, take))

    # the top window's multiple starts the ladder: c doublings of zero and
    # an add to zero would leave it unchanged
    acc = pick(mag.shape[0] - 1)
    for w in range(mag.shape[0] - 2, -1, -1):
        acc = curve.add(curve.double_times(acc, c), pick(w))
    return acc


def _last(p):
    return p[0][0].shape[-1] if isinstance(p[0], tuple) else p[0].shape[-1]


def _zero_points(like, n):
    """All-zero Jacobian leaves [.., n] shaped like `like`'s leaves."""
    return map_leaf(like, lambda a: torch.zeros(
        a.shape[:-1] + (n,), dtype=a.dtype, device=a.device))


class MSMDevice:
    def __init__(self, curve, window_bits: int = 16):
        if not 1 <= window_bits <= LIMB_BITS:
            raise ValueError("window_bits must be in 1..16")
        self.curve = curve
        self.c = window_bits

    def signed_digits(self, scalar_limbs):
        return signed_window_digits(scalar_limbs, self.c)

    def msm(self, scalar_limbs, points):
        """scalar_limbs: [n_limbs, *K, N] 16-bit planes, LSB first, for a
        batch K of MSMs over N points each.  points: affine (X, Y), leaves
        [.., *K, N], Montgomery, zero = (0, 0).  Returns per-window signed
        sums, Jacobian leaves [.., *K, W] (LSB window first)."""
        if len(points) != 2:
            raise ValueError("MSM consumes affine (X, Y) points")
        C = self.curve
        kshape = tuple(scalar_limbs.shape[1:-1])
        N = scalar_limbs.shape[-1]
        KN = scalar_limbs[0].numel()
        K = KN // N if N else 0
        with span("msm.digits"):
            mag, neg = self.signed_digits(scalar_limbs.reshape(-1, KN))
        W = mag.shape[0]
        B = 1 << (self.c - 1)                  # buckets 1..B per window
        with span("msm.sort"):
            pts = map_leaf(points, lambda a: a.reshape(a.shape[0], KN))
            jac_like = (pts[0], pts[1], pts[0])
            flat = mag.reshape(-1)
            ent = torch.nonzero(flat).squeeze(1)
            if ent.numel() == 0:
                zero = _zero_points(jac_like, K * W)
                return map_leaf(zero, lambda a: a.reshape(
                    a.shape[:-1] + kshape + (W,)))

            # sort the nonzero entries by (msm, window, bucket)
            lane = ent % KN
            seg = (lane // N) * W + ent // KN  # one segment per (msm, window)
            skey, order = torch.sort(seg * (B + 1) + flat[ent])
            ent = ent[order]
            lane = lane[order]
            sgn = neg.reshape(-1)[ent]
            px = map_leaf(pts[0], lambda a: torch.index_select(a, -1, lane))
            py = map_leaf(pts[1], lambda a: torch.index_select(a, -1, lane))
            py = C.F.cneg(sgn, py)

        S = K * W                              # segments
        with span("msm.bucket_scan"):
            acc = seg_scan(C, skey, (px, py))
            # bucket sums sit at the run ends
            M = skey.shape[0]
            is_end = torch.ones(M, dtype=torch.bool, device=skey.device)
            is_end[:-1] = skey[1:] != skey[:-1]
            pos = torch.nonzero(is_end).squeeze(1)
            bid = skey[pos]
            dense = (bid // (B + 1)) * B + (bid % (B + 1) - 1)
            buckets = map_leaf2(
                _zero_points(jac_like, S * B), acc,
                lambda z, a: z.index_copy(z.dim() - 1, dense,
                                          torch.index_select(a, -1, pos)))

        # triangle: sum_b b*S_b = sum of the suffix sums, per segment
        with span("msm.triangle"):
            rev = map_leaf(buckets, lambda a: a.reshape(
                a.shape[:-1] + (S, B)).flip(-1).reshape(a.shape))
            skeys = torch.arange(S, device=skey.device).repeat_interleave(B)
            suf = seg_scan(C, skeys, rev)
        with span("msm.reduce"):
            win = reduce_last(C, map_leaf(
                suf, lambda a: a.reshape(a.shape[:-1] + (S, B))))
            return map_leaf(win, lambda a: a[..., 0].reshape(
                a.shape[:-2] + kshape + (W,)))

    def msm_point(self, scalar_limbs, points):
        """Full MSM folded to one Jacobian point per batch entry (leaves
        [.., *K])."""
        with span("msm"):
            win = self.msm(scalar_limbs, points)
            with span("msm.fold"):
                return fold_windows_device(self.curve, win, self.c)


def fold_windows_device(curve, win, window_bits: int):
    """MSB -> LSB window fold: c doublings + 1 add per window (on a
    kernel-backed G1 the c doublings are one K7 launch, as the JAX
    package's fold runs them in one fori_loop).  win: Jacobian leaves
    [.., W].  Returns leaves [..]."""
    W = _last(win)
    acc = None
    for w in range(W - 1, -1, -1):
        pw = map_leaf(win, lambda a: a[..., w:w + 1])
        if acc is None:
            acc = pw
            continue
        acc = curve.add(curve.double_times(acc, window_bits), pw)
    return map_leaf(acc, lambda a: a[..., 0])


def fold_windows(oracle_curve, window_points, window_bits: int):
    """Host-side MSB->LSB fold of per-window sums (oracle bigint points)."""
    res = oracle_curve.zero()
    for p in reversed(window_points):
        for _ in range(window_bits):
            res = oracle_curve.double(res)
        res = oracle_curve.add(res, p)
    return res
