"""Readings that several metrics' readers share: the work of an
operation from the frozen counts, the device's busy time in a cell's
phases, its idle share, and launches per proof."""

from __future__ import annotations

import statistics

from .counts import least_s
from .counts.msm import msm_mix, pippenger
from .counts.ntt import calc_h
from .counts.pairing import verify_batch


def prove_work(s: dict) -> dict:
    """(operations, bytes) of one proof's layers: "msm" the four G1 MSMs
    (A and B1 over every signal, C over the private ones, H over the
    domain) and the G2 MSM over every signal, the witness's bit signals
    at one bit; "calc_h"."""
    fq, fr, bits = s["fq_words"], s["fr_words"], s["scalar_bits"]
    priv_wide = s["n_wide"] - s["n_public"] - 1
    parts = [msm_mix(s["n_wide"], s["n_bits"], bits, fq, 1),
             msm_mix(s["n_wide"], s["n_bits"], bits, fq, 1),
             msm_mix(priv_wide, s["n_bits"], bits, fq, 1),
             pippenger(s["domain"], bits, fq, 1),
             msm_mix(s["n_wide"], s["n_bits"], bits, fq, 2)]
    return {"msm": (sum(p[0] for p in parts), sum(p[1] for p in parts)),
            "calc_h": calc_h(fr, s["domain"], s["nnz_a"] + s["nnz_b"],
                             s["n_signals"])}


def verify_work(s: dict, lanes: int) -> dict:
    """(operations, bytes) of a batch's pairing."""
    return {"pairing": verify_batch(s["curve"], s["fq_words"], lanes)}


def phase_busy(rec, labels) -> float:
    """Device-busy seconds inside the traced phases with these labels."""
    return sum(rec.trace.busy(a, b) for label, a, b in rec.phases
               if label in labels)


def phase_count(rec, label: str) -> int:
    return sum(1 for lab, _, _ in rec.phases if lab == label)


def roofline_pct(least: float, busy: float):
    return 100.0 * least / busy if busy > 0 else None


def least(work) -> float:
    return least_s(*work)


def idle_pct(rec):
    """The share of the traced window in which nothing ran on the device
    (None without a trace or with nothing on the device)."""
    if rec.trace is None or rec.trace.window is None:
        return None
    lo, hi = rec.trace.window
    busy = rec.trace.busy(lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo)) if busy > 0 else None


def launches_per_lane(rec):
    lanes = sum(op.lanes for op in rec.done)
    return rec.launches / lanes if rec.launches and lanes else None


def median_phase(rec, key: str):
    vals = [op.timings[key] for op in rec.done
            if op.timings and key in op.timings]
    return statistics.median(vals) if vals else None

