"""The frozen counts give the operations and bytes PERF.md's kernel table
reckons at 2^16 lanes, and depend on sizes alone."""

import pytest

from snarkbench import readings
from snarkbench.counts import PEAK_OPS, least_s, mm
from snarkbench.counts.curve import jac_add, jac_dbl, jac_madd
from snarkbench.counts.msm import msm_mix, pippenger
from snarkbench.counts.ntt import ntt
from snarkbench.counts.pairing import pairing_lane

N = 1 << 16


@pytest.mark.parametrize("fn, w, ms", [
    (jac_add, 8, 0.0113), (jac_add, 12, 0.0199), (jac_madd, 8, 0.0100),
    (jac_madd, 12, 0.0150), (jac_dbl, 8, 0.0075), (jac_dbl, 12, 0.0113)])
def test_group_law_bounds_at_2_16(fn, w, ms):
    ops, nbytes = fn(w)
    assert round(least_s(N * nbytes, N * ops) * 1e3, 4) == ms


def test_ntt_bound_at_2_16():
    ops, nbytes = ntt(8, N, False)
    assert round(least_s(nbytes, ops) * 1e3, 4) == 0.0051
    assert ops / PEAK_OPS > nbytes / 3.35e12


def test_montgomery_product():
    assert mm(8) == 280 and mm(12) == 612


def test_pippenger():
    madd = jac_madd(12)[0]
    assert pippenger(1000, 1, 12)[0] == 1000 * madd
    small, big = pippenger(1 << 10, 255, 12)[0], pippenger(1 << 17, 255, 12)[0]
    assert big < (1 << 7) * small      # the window grows with n
    assert pippenger(1 << 17, 255, 12, 2)[0] > pippenger(1 << 17, 255, 12)[0]
    a = msm_mix(100, 50, 255, 8)
    assert a == tuple(x + y for x, y in zip(pippenger(100, 255, 8),
                                           pippenger(50, 1, 8)))


def test_prove_work_from_sizes_alone():
    sizes = {"n_signals": 98778, "n_public": 7, "n_bits": 60000,
             "n_wide": 38778, "domain": 1 << 17, "nnz_a": 200000,
             "nnz_b": 130000, "fq_words": 12, "fr_words": 8,
             "scalar_bits": 255}
    w1, w2 = readings.prove_work(sizes), readings.prove_work(dict(sizes))
    assert w1 == w2
    assert 0 < readings.least(w1["msm"]) < 0.1
    assert 0 < readings.least(w1["calc_h"]) < 0.01


def test_pairing_counts():
    assert pairing_lane("bls12381", 12) > pairing_lane("bn128", 8) > 0
    work = readings.verify_work({"curve": "bn128", "fq_words": 8}, 1024)
    assert 0 < readings.least(work["pairing"]) < 0.05
