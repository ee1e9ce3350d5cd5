"""Hand state of the JAX package to the port and back.

`proving_key_from_numpy` takes the JAX package's parsed `ProvingKey` (its
numpy limb planes and sparse LC tables) by duck typing — this module
imports nothing of that package — and returns the port's ProvingKey, so
both packages prove from the same state.  `tower_from_numpy` and
`tower_to_numpy` carry tower state between the JAX package's uint32
planes and the port's int32 tensors: F2, F6 and F12 elements,
prepared-coefficient trees with a step axis (such as MNT6753's
[S, L, *B] (c_y, c_x, c_0) stacks), and the MNT6753 Pedersen window
tables (Mnt6753Device._window_tables, a (tx, ty) pair of [L, n_win, 4]
planes, the layout of the port's models/mnt6753_device.py).
"""

from __future__ import annotations

import numpy as np

from .groth16.pkey import ProvingKey
from .ops.fp import planes, to_numpy
from .ops.pol import SparseLC


def _planes(tree):
    if isinstance(tree, tuple):
        return tuple(_planes(t) for t in tree)
    return np.array(tree, dtype=np.uint32)


def _sparse(lc) -> SparseLC:
    return SparseLC(sig_idx=np.array(lc.sig_idx, dtype=np.int32),
                    coef_idx=np.array(lc.coef_idx, dtype=np.int32),
                    coefs=np.array(lc.coefs, dtype=np.uint32),
                    domain_size=int(lc.domain_size))


def proving_key_from_numpy(pk) -> ProvingKey:
    """Any object with the JAX package's ProvingKey fields -> the port's."""
    return ProvingKey(
        n_signals=int(pk.n_signals), n_public=int(pk.n_public),
        domain_size=int(pk.domain_size),
        alfa1=tuple(pk.alfa1), beta1=tuple(pk.beta1),
        delta1=tuple(pk.delta1), beta2=tuple(pk.beta2),
        delta2=tuple(pk.delta2),
        pols_a=_sparse(pk.pols_a), pols_b=_sparse(pk.pols_b),
        points_a=_planes(pk.points_a), points_b1=_planes(pk.points_b1),
        points_b2=_planes(pk.points_b2), points_c=_planes(pk.points_c),
        h_exps=_planes(pk.h_exps))


def tower_from_numpy(tree, device):
    """Nested tuples of uint32 limb planes (numpy or anything numpy reads,
    such as JAX arrays) -> the same tree of int32 tensors on `device`."""
    if isinstance(tree, tuple):
        return tuple(tower_from_numpy(t, device) for t in tree)
    return planes(np.asarray(tree), device)


def tower_to_numpy(tree):
    """Inverse of tower_from_numpy: int32 tensors -> uint32 numpy planes."""
    if isinstance(tree, tuple):
        return tuple(tower_to_numpy(t) for t in tree)
    return to_numpy(tree)
