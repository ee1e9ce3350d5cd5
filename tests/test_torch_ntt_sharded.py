"""The domain-sharded NTT and CALC_H of wasmsnark_tpu_torch/parallel/
mesh.py (ShardedNTT) on 4 ranks over gloo on the CPU, against the JAX
package's NTTDevice, its domain-sharded round trip and
Groth16Prover(mesh=make_mesh(4)).calc_h, bit for bit; the prove on 4
ranks and on a 2 x 2 mesh (CALC_H split over "host", H re-cut to the
"points" blocks) against the port's unsharded proof, which the JAX
package's verifier accepts under the JAX setup's vk (a JAX prove of this
circuit would cost minutes of XLA compiles on the CPU).

One spawn of 4 ranks runs every case (this file run as a script, with
tests/test_torch_mesh.py's helpers):

    PYTHONPATH=. python tests/test_torch_ntt_sharded.py ranks_4 <rank> 4 <dir>
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from test_torch_mesh import (  # noqa: E402
    CPU, ROUND_TRIP_BITS, check_calc_h, check_ntt, check_round_trip,
    jax_references, join, rank_main, rank_ntt, rank_prove, spawn,
    write_keys)
from wasmsnark_tpu_torch.ops.ntt import NTTDevice  # noqa: E402
from wasmsnark_tpu_torch.parallel.mesh import (  # noqa: E402
    ShardedNTT, layout, make_mesh, make_mesh_2d)

torch.set_num_threads(1)

D = 4
# N = D^2 and the two sizes of 2^8-2^11 that the 2-rank cases leave
NTT_BITS_4 = (4, 9, 11)
K4 = 12                  # square_chain_circuit(12): a domain of 16 = D^2


def _rank_ranks_4(rank, tmp):
    """Every 4-rank case: the sharded transforms, the prove and calc_h on
    make_mesh(), which domains the split refuses, and the prove on
    make_mesh_2d(2, 2)."""
    from wasmsnark_tpu_torch.models import curve_module
    from wasmsnark_tpu_torch.ops.fp import FpDevice
    mesh = make_mesh(device="cpu")
    rank_ntt(rank, tmp, mesh, NTT_BITS_4, ROUND_TRIP_BITS)
    rank_prove(rank, tmp, mesh, "k12")
    m = curve_module("bn128")
    sh = ShardedNTT(NTTDevice(m.ntt_spec, FpDevice(m.fr_spec, CPU)), mesh)
    (tmp / f"refused{rank}.json").write_text(json.dumps(
        {n: sh.unsupported(n) for n in (8, 16, 24)}))
    rank_prove(rank, tmp, make_mesh_2d(2, 2, device="cpu"), "k12_2x2",
               calc_h=False, key="k12")


RANK_CASES = {"ranks_4": _rank_ranks_4}


@pytest.fixture(scope="module")
def ranks_4(tmp_path_factory):
    """One spawn of 4 ranks; the JAX package's results, the port's
    unsharded proof and QAP upload, and the JAX package's verdicts on
    that proof and on a tampered copy, computed meanwhile."""
    import wasmsnark_tpu
    from wasmsnark_tpu_torch.groth16.prover import Groth16Prover
    tmp = tmp_path_factory.mktemp("mesh4")
    pkey, wit, vk, pub = write_keys(tmp, "k12", K4)
    procs = spawn("ranks_4", D, tmp, script=__file__)
    try:
        want = jax_references(NTT_BITS_4, ROUND_TRIP_BITS, D, pkey, wit)
        whole = Groth16Prover(device=CPU, msm_window_bits=4)
        want["proof"] = whole.prove(wit, pkey, rng=7)
        bad = json.loads(json.dumps(want["proof"]))
        bad["pi_c"][0] = str(int(bad["pi_c"][0]) + 1)
        rt = wasmsnark_tpu.build_bn128()
        want["verdicts"] = [rt.groth16_verify(vk, pub, p)
                            for p in (want["proof"], bad)]
        dev = whole._key(pkey)[1]
        want["qap_entries"] = [dev[k]["sig_idx"].numel()
                               for k in ("lca", "lcb")]
        want["qap_bytes"] = sum(
            t.numel() * t.element_size() for k in ("lca", "lcb")
            for t in dev[k].values() if isinstance(t, torch.Tensor))
    finally:
        join(procs, tmp)
    return tmp, want


def _rec(tmp, name, r):
    return json.loads((tmp / f"{name}{r}.json").read_text())


@pytest.mark.parametrize("bits", NTT_BITS_4)
def test_sharded_ntt_4_ranks_matches_jax(ranks_4, bits):
    """ShardedNTT's fft, ifft and their odd forms on 4 ranks (2^4 = D^2
    points among the sizes): each rank's block bit for bit the JAX
    NTTDevice's."""
    check_ntt(*ranks_4, D, bits)


def test_sharded_round_trip_4_ranks_matches_jax(ranks_4):
    check_round_trip(*ranks_4, D, len(NTT_BITS_4))


def test_sharded_calc_h_4_ranks_matches_jax(ranks_4):
    """calc_h of square_chain_circuit(12) (a domain of 16 = D^2) on 4
    ranks, split: each rank's block of H is the JAX prover's under
    make_mesh(4)."""
    tmp, want = ranks_4
    check_calc_h(tmp, want["calc_h"], D, "k12")


def test_prove_on_4_ranks_verifies_under_jax(ranks_4):
    """The prove on 4 ranks, CALC_H split and H passed to the MSM as it
    is (n_pad is the domain): every rank's proof JSON equals the port's
    unsharded proof byte for byte, which the JAX package's verifier
    accepts (and a tampered copy not)."""
    tmp, want = ranks_4
    assert want["verdicts"] == [True, False]
    for r in range(D):
        rec = _rec(tmp, "k12", r)
        assert rec["path"] == "sharded" and not rec["recut"], rec
        assert json.dumps(rec["proof"]) == json.dumps(want["proof"]), r


def test_prove_on_2x2_mesh_recuts_h(ranks_4):
    """On make_mesh_2d(2, 2) CALC_H splits over "host" (2 ranks a group)
    and the MSMs over "points": H is gathered over "host" and re-cut (one
    collective), and every rank's proof JSON equals the port's unsharded
    proof, which the JAX package's verifier accepts."""
    tmp, want = ranks_4
    assert want["verdicts"] == [True, False]
    for r in range(D):
        rec = _rec(tmp, "k12_2x2", r)
        assert rec["path"] == "sharded" and rec["recut"], rec
        assert rec["exchanges"] == {"ifft": 1, "fft_odd": 1, "ifft_2n": 1,
                                    "h_blocks": 1}, rec["exchanges"]
        assert json.dumps(rec["proof"]) == json.dumps(want["proof"]), r


def test_qap_upload_is_the_ranks_part(ranks_4):
    """Each rank uploads only the QAP entries of its domain columns: the
    ranks' entries partition the whole, and a rank holds about 1/D of its
    bytes."""
    tmp, want = ranks_4
    recs = [_rec(tmp, "k12", r) for r in range(D)]
    assert [sum(e) for e in zip(*(r["qap_entries"] for r in recs))] == \
        want["qap_entries"]
    for rec in recs:
        assert rec["qap_bytes"] <= 1.5 * want["qap_bytes"] / D, rec


def test_split_refuses_small_domains(ranks_4):
    """4 ranks split a transform of 16 = D^2 points or more, a power of
    two; 8 and 24 are refused with the reason."""
    tmp, _ = ranks_4
    for r in range(D):
        got = _rec(tmp, "refused", r)
        assert got["16"] is None
        assert "not a power of two >= 4^2" in got["8"]
        assert "not a power of two >= 4^2" in got["24"]


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_layouts_partition_the_domain(ranks):
    """Every layout over `ranks` ranks holds each index of a 2^7-point axis
    on exactly one rank ("upper": each of its upper half), a chunk of
    "chunks_rev" holds one element of every block, and "chunks" and
    "chunks_mirror" differ by the mirror t -> -t mod D in each chunk."""
    n = 1 << 7
    M = n // ranks
    for kind, want in (("block", n), ("strided", n), ("chunks_rev", n),
                       ("chunks", n), ("chunks_mirror", n),
                       ("upper", n // 2)):
        got = np.concatenate([layout(kind, n, ranks, r)
                              for r in range(ranks)])
        np.testing.assert_array_equal(np.sort(got), np.arange(n - want, n),
                                      err_msg=kind)
    for r in range(ranks):
        chunks = layout("chunks_rev", n, ranks, r).reshape(-1, ranks)
        np.testing.assert_array_equal(np.sort(chunks // M, axis=1),
                                      np.tile(np.arange(ranks),
                                              (M // ranks, 1)))
        nat = layout("chunks", n, ranks, r).reshape(-1, ranks)
        mir = layout("chunks_mirror", n, ranks, r).reshape(-1, ranks)
        np.testing.assert_array_equal(
            mir, nat[:, (-np.arange(ranks)) % ranks])


if __name__ == "__main__":
    rank_main(RANK_CASES, sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
