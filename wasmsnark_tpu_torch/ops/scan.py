"""Segmented prefix sums and halving sums of curve points along the last
axis, PyTorch port of the role of wasmsnark_tpu/ops/scan.py (seg_scan,
reduce_last).

The JAX package runs a chunk-local sequential scan with a log-depth carry
recursion, shaped for the TPU's sequential grid.  Here a step is one
batched group-law launch over every lane that still has work, Hillis-Steele
style: at distance d, lane i adds lane i - d when both lie in one segment.
After the step at distance d each lane holds the sum of the last 2d
entries of its segment, so the loop ends when no segment is longer than d.
Lanes whose segment is already complete are left out of the launch.
Jacobian results depend on the summation order; the sums are the same
group elements.
"""

from __future__ import annotations

import torch

from .curve import map_leaf, map_leaf2


def _take(p, idx):
    return map_leaf(p, lambda a: torch.index_select(a, a.dim() - 1, idx))


def _put(p, idx, vals):
    return map_leaf2(p, vals, lambda a, v: a.index_copy(a.dim() - 1, idx, v))


def seg_scan(curve, keys, p):
    """Inclusive segmented prefix sums along the last axis.

    keys [M]: segment labels, equal labels contiguous (sorted).
    p: Jacobian (X, Y, Z) or affine (X, Y) points, leaves [.., M]; affine
    input (zero written (0, 0)) takes its first step with the mixed add.
    Returns Jacobian leaves [.., M]."""
    M = keys.shape[0]
    affine = len(p) == 2
    acc = curve.promote(p) if affine else p
    d = 1
    while d < M:
        idx = torch.nonzero(keys[d:] == keys[:-d]).squeeze(1) + d
        if idx.numel() == 0:
            break
        cur = _take(acc, idx)
        if affine and d == 1:
            # lane i adds the affine entry i - 1
            s = curve.madd(cur, _take(p, idx - d))
        else:
            s = curve.add(_take(acc, idx - d), cur)
        acc = _put(acc, idx, s)
        d *= 2
    return acc


def reduce_last(curve, p):
    """Sum along the last axis (any length) by halving; a length that is
    not a power of two is first padded with zero points (all-zero leaves,
    Z = 0) to the next one.  Returns leaves with the last axis of size
    1."""
    n = p[0][0].shape[-1] if isinstance(p[0], tuple) else p[0].shape[-1]
    if n & (n - 1):
        pad = (1 << n.bit_length()) - n
        p = map_leaf(p, lambda a: torch.nn.functional.pad(a, (0, pad)))
        n += pad
    while n > 1:
        half = n // 2
        p = curve.add(map_leaf(p, lambda a: a[..., :half]),
                      map_leaf(p, lambda a: a[..., half:n]))
        n = half
    return p
