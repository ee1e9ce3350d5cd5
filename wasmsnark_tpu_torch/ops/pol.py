"""QAP linear combination, PyTorch port of wasmsnark_tpu/ops/pol.py
(SparseLC, lc_arrays, construct_lc) — the semantics of the reference's
pol_constructLC: res[coefIdx] += signal_i * coef.

The sparse walk is one batched Montgomery multiply (K1) of every (signal,
coef) pair, then an exact int64 `index_add_` of the product limbs into
the domain columns (integer adds, so the order is immaterial), and one
wide-sum reduction mod q.  The JAX package reaches the same sums through a
uint32 cumsum that wraps mod 2^32; int64 needs no wrap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fp import FpDevice, planes


@dataclasses.dataclass
class SparseLC:
    """Host sparse QAP matrix (one of polsA / polsB).

    sig_idx[k]  : which signal multiplies entry k
    coef_idx[k] : which domain evaluation index receives it
    coefs       : [L, nnz] Montgomery-form Fr limb planes (uint32 numpy)
    """

    sig_idx: np.ndarray
    coef_idx: np.ndarray
    coefs: np.ndarray
    domain_size: int

    def __post_init__(self):
        counts = np.bincount(np.asarray(self.coef_idx, dtype=np.int64),
                             minlength=self.domain_size)
        if counts.max(initial=0) >= (1 << 16):
            raise ValueError("constructLC requires < 2^16 contributions per "
                             "domain index")


def lc_arrays(lc: SparseLC, device, columns=None) -> dict:
    """The SparseLC tables as tensors on `device` (uploaded once per key).
    columns: the global domain index of each local column (a rank's part of
    a domain split over a mesh, parallel/mesh.py `layout`); then only the
    entries that land there are uploaded, their coef_idx rebased to the
    local columns, and construct_lc returns those columns (a column is one
    domain index, so SparseLC's < 2^16 bound holds on every rank's part)."""
    sig = np.asarray(lc.sig_idx, dtype=np.int64)
    col = np.asarray(lc.coef_idx, dtype=np.int64)
    coefs, size = lc.coefs, lc.domain_size
    if columns is not None:
        local = np.full(lc.domain_size, -1, np.int64)
        local[columns] = np.arange(len(columns))
        rows = np.nonzero(local[col] >= 0)[0]
        sig, col = sig[rows], local[col[rows]]
        coefs, size = np.asarray(coefs)[:, rows], len(columns)
    return {
        "sig_idx": torch.from_numpy(sig).to(device),
        "coef_idx": torch.from_numpy(col).to(device),
        "coefs": planes(coefs, device),
        "domain_size": size,
    }


def construct_lc(F: FpDevice, lc, signals_mont):
    """signals_mont: [L, nSignals] Montgomery.  Returns [L, domain]
    Montgomery evaluations of sum_i signal_i * P_i on the domain."""
    arrs = lc if isinstance(lc, dict) else lc_arrays(lc, signals_mont.device)
    sig = torch.index_select(signals_mont, 1, arrs["sig_idx"])
    prods = F.mont_mul(sig, arrs["coefs"])
    acc = torch.zeros((F.L, arrs["domain_size"]), dtype=torch.int64,
                      device=signals_mont.device)
    acc.index_add_(1, arrs["coef_idx"], prods.long())
    return F.reduce_wide_sum(acc)
