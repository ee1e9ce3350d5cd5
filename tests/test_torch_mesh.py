"""The point-sharded MSM, the domain-sharded NTT and CALC_H, and the
sharded prove of wasmsnark_tpu_torch/parallel/mesh.py on the CPU over
gloo, against the JAX package's msm_sharded, NTTDevice, sharded round
trip, Groth16Prover(mesh=...).calc_h and prove, and the port's host
oracle.  tests/test_torch_ntt_sharded.py runs the same cases on 4 ranks
with these helpers.

A rank is a process: the tests start their ranks as subprocesses of this
file run as a script,

    PYTHONPATH=. python tests/test_torch_mesh.py <case> <rank> <world> <dir>

which meet through a file store in the test's temporary directory (so
test workers cannot clash on ports) and write their results there; one
spawn serves every test of its world size.  The
top level imports neither jax nor wasmsnark_tpu: the ranks import the port
only, and the tests import the JAX package inside.  Jacobian sums are
compared affine against the references and bit for bit across ranks;
proofs as JSON, byte for byte.
"""

import json
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from wasmsnark_tpu_torch.models import curve_module  # noqa: E402
from wasmsnark_tpu_torch.ops.curve import (  # noqa: E402
    JacobianDevice, map_leaf)
from wasmsnark_tpu_torch.ops.fp import FpDevice, to_numpy  # noqa: E402
from wasmsnark_tpu_torch.ops.msm import MSMDevice  # noqa: E402
from wasmsnark_tpu_torch.ops.towers import F2Device, FpAdapter  # noqa: E402
from wasmsnark_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_mesh_2d, msm_sharded, msm_sharded_point)
from wasmsnark_tpu_torch.utils.serialize import (  # noqa: E402
    ints_to_limbs_fast)

# Test workers share the cores: one intra-op thread each.
torch.set_num_threads(1)

CPU = torch.device("cpu")
RANK_TIMEOUT_S = 120              # every rank of one spawn, together
K = 3                             # square_chain_circuit(K), as the JAX e2e
# the sharded transforms on 2 ranks: N = D^2 and two sizes of 2^8-2^11
# (tests/test_torch_ntt_sharded.py takes the others on 4 ranks)
NTT_BITS_2 = (2, 8, 10)
ROUND_TRIP_BITS = 10              # the sharded round trip, against JAX's
# the 3-rank cases: (curve, group, N); N = 2 leaves a rank of padding
ORACLE_CASES = [("bn128", "g2", 10), ("bn128", "g2", 2),
                ("bls12381", "g1", 10), ("bls12381", "g1", 2)]


def _group_device(curve, group):
    m = curve_module(curve)
    a1 = FpAdapter(FpDevice(m.fp_spec, CPU))
    return m, JacobianDevice(a1 if group == "g1" else F2Device(a1, a1.neg))


def _leaves(p):
    return [x for c in p for x in _leaves(c)] if isinstance(p, tuple) \
        else [to_numpy(p)]


def _save(path, p):
    np.savez(path, *_leaves(p))


def _load(path):
    with np.load(path) as z:
        return [z[f"arr_{i}"] for i in range(len(z.files))]


def _mont_planes(m, vals):
    return to_numpy(FpDevice(m.fp_spec, CPU).pack_mont(vals))


def _affine_planes(m, group, pts):
    """Oracle points -> affine (X, Y) Montgomery planes (zero: (0, 0))."""
    G = getattr(m, group.upper())
    zero = (0, 0) if group == "g1" else ((0, 0), (0, 0))
    aff = [zero if G.is_zero(p) else G.affine(p)[:2] for p in pts]
    if group == "g1":
        return [_mont_planes(m, [a[i] for a in aff]) for i in range(2)]
    return [_mont_planes(m, [a[i][j] for a in aff])
            for i in range(2) for j in range(2)]


def _points(m, group, leaves):
    """Jacobian Montgomery planes [L, n] (3 or 6 of them) -> oracle
    points."""
    F = FpDevice(m.fp_spec, CPU)
    ints = [F.unpack_mont(a.reshape(a.shape[0], -1)) for a in leaves]
    if group == "g1":
        return list(zip(*ints))
    return [tuple((ints[2 * i][k], ints[2 * i + 1][k]) for i in range(3))
            for k in range(len(ints[0]))]


def _same(G, a, b):
    if G.is_zero(a) or G.is_zero(b):
        return G.is_zero(a) and G.is_zero(b)
    return G.eq(a, b)


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _rank_g1_2x4(rank, tmp):
    """BN128 G1 window sums over make_mesh_2d(2, 4), c = 4."""
    x, y, s = _load(tmp / "in.npz")
    _, G1d = _group_device("bn128", "g1")
    run = msm_sharded(MSMDevice(G1d, window_bits=4),
                      make_mesh_2d(2, 4, device="cpu"),
                      axis=("host", "points"))
    _save(tmp / f"out{rank}.npz", run(s, (x, y)))


def _rank_oracle_3(rank, tmp):
    """msm_sharded_point over a 1-D mesh of 3 ranks, each ORACLE_CASES;
    then the prove, whose CALC_H runs whole (3 is not a power of two)."""
    mesh = make_mesh(device="cpu")
    rank_prove(rank, tmp, mesh, "k3", calc_h=False)
    for i, (curve, group, _) in enumerate(ORACLE_CASES):
        planes = _load(tmp / f"in{i}.npz")
        s = planes.pop()
        pts = (planes[0], planes[1]) if group == "g1" else (
            (planes[0], planes[1]), (planes[2], planes[3]))
        _, Gd = _group_device(curve, group)
        run = msm_sharded_point(MSMDevice(Gd, window_bits=4), mesh)
        _save(tmp / f"out{i}_{rank}.npz",
              map_leaf(run(s, pts), lambda a: a[..., None]))


def ntt_input(bits):
    """Seeded canonical Fr planes [16, 2^bits] (below 2^252 < r)."""
    x = np.random.default_rng(bits).integers(
        0, 1 << 16, size=(16, 1 << bits), dtype=np.uint32)
    x[-1] &= 0x0FFF
    return x


def rank_ntt(rank, tmp, mesh, sizes, rt_bits):
    """The four sharded transforms of this rank's block of ntt_input(bits)
    for each of `sizes`, and ifft(fft(.)) at rt_bits, to
    tmp/ntt<rank>.npz; the exchanges to tmp/ntt<rank>.json."""
    from wasmsnark_tpu_torch.ops.fp import planes
    from wasmsnark_tpu_torch.ops.ntt import NTTDevice
    from wasmsnark_tpu_torch.parallel.mesh import ShardedNTT
    m = curve_module("bn128")
    sh = ShardedNTT(NTTDevice(m.ntt_spec, FpDevice(m.fr_spec, CPU)), mesh)
    out = {}
    for bits in sorted(set(sizes) | {rt_bits}):
        M = (1 << bits) // sh.D
        x = planes(ntt_input(bits)[:, sh.index * M:(sh.index + 1) * M], CPU)
        if bits in sizes:
            for odd in (False, True):
                out[f"fft{int(odd)}_{bits}"] = sh.fft(x, odd)
                out[f"ifft{int(odd)}_{bits}"] = sh.ifft(x, odd)
        if bits == rt_bits:
            out["rt"] = sh.ifft(sh.fft(x))
    np.savez(tmp / f"ntt{rank}.npz",
             **{k: to_numpy(v) for k, v in out.items()})
    (tmp / f"ntt{rank}.json").write_text(json.dumps({
        "index": sh.index, "exchanges": sh.exchanges,
        "bytes": sh.exchange_bytes}))


def rank_prove(rank, tmp, mesh, name, calc_h=True, key=None):
    """The BN128 prove of tmp/<key>.pkey and .wit (key: default name) on
    `mesh` (c = 4, rng = 7), then calc_h alone: the proof, the CALC_H path
    and exchanges, the blocks held and the QAP upload to
    tmp/<name><rank>.json, this rank's H block to tmp/<name><rank>.npy."""
    from wasmsnark_tpu_torch.groth16.pkey import read_witness
    from wasmsnark_tpu_torch.groth16.prover import Groth16Prover
    from wasmsnark_tpu_torch.ops.fp import planes
    pkey = (tmp / f"{key or name}.pkey").read_bytes()
    wit = (tmp / f"{key or name}.wit").read_bytes()
    prover = Groth16Prover(device="cpu", mesh=mesh, msm_window_bits=4)
    proof = prover.prove(wit, pkey, rng=7)
    pk, dev = prover._key(pkey)
    rec = {"proof": proof, "path": prover.calc_h_path,
           "why": prover.calc_h_whole_reason, "recut": prover.h_recut,
           "n_pad": dev["n_pad"], "domain": pk.domain_size,
           "g1_block": dev["g1"][0].shape[-1],
           "b2_block": dev["points_b2"][0][0].shape[-1],
           "qap_entries": [dev[k]["sig_idx"].numel() for k in ("lca", "lcb")],
           "qap_bytes": sum(t.numel() * t.element_size()
                            for k in ("lca", "lcb") for t in dev[k].values()
                            if isinstance(t, torch.Tensor))}
    split = prover._calc_h_split(pk.domain_size)
    if split is not None:
        rec["exchanges"] = split.exchanges
    if calc_h:
        sig = planes(read_witness(wit, curve_module("bn128").fr_spec), CPU)
        np.save(tmp / f"{name}{rank}.npy", to_numpy(prover.calc_h(pk, sig)))
    (tmp / f"{name}{rank}.json").write_text(json.dumps(rec))


def _rank_ranks_2(rank, tmp):
    """Every 2-rank case: the sharded transforms, the prove and calc_h."""
    mesh = make_mesh(device="cpu")
    rank_ntt(rank, tmp, mesh, NTT_BITS_2, ROUND_TRIP_BITS)
    rank_prove(rank, tmp, mesh, "k3")


RANK_CASES = {"g1_2x4": _rank_g1_2x4, "oracle_3": _rank_oracle_3,
              "ranks_2": _rank_ranks_2}


def rank_main(cases, case, rank, world, tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        cases[case](rank, pathlib.Path(tmp))
    finally:
        dist.destroy_process_group()


def spawn(case, world, tmp, script=__file__):
    """Start the `world` ranks of `case` (`script` run with its
    arguments); returns their processes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, script, case, str(r), str(world),
                 str(tmp)], env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def join(procs, tmp):
    """Wait for every rank, within RANK_TIMEOUT_S together; kill them all
    past it.  Any non-zero exit fails, with the rank's log."""
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, (tmp / f"rank{r}.log").read_text()[-4000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad


def write_keys(tmp, name, k):
    """The BN128 key and witness of square_chain_circuit(k) (the JAX
    package's setup, seed 1, x = 5) to tmp/<name>.pkey and .wit; returns
    them with the vk and the public inputs."""
    from wasmsnark_tpu.groth16 import setup as jsetup
    from wasmsnark_tpu.groth16.pkey import write_witness
    pkey, vk, _ = jsetup.setup(jsetup.square_chain_circuit(k), seed=1)
    signals = jsetup.square_chain_witness(k, 5)
    wit = write_witness(signals, curve_module("bn128").fr_spec)
    (tmp / f"{name}.pkey").write_bytes(pkey)
    (tmp / f"{name}.wit").write_bytes(wit)
    return pkey, wit, vk, [str(signals[1])]


def jax_references(sizes, rt_bits, D, pkey, wit):
    """The JAX package's results for the sharded cases on D ranks: fft,
    odd fft, ifft and odd ifft of ntt_input(bits) for each of `sizes`
    (NTTDevice, jitted), the domain-sharded round trip of
    ntt_input(rt_bits) on Mesh(devs[:D]) with P(None, "d"), gathered, and
    Groth16Prover(mesh=make_mesh(D)).calc_h of the key and witness,
    gathered."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from wasmsnark_tpu.groth16.pkey import parse_pkey, read_witness
    from wasmsnark_tpu.groth16.prover import Groth16Prover as JProver
    from wasmsnark_tpu.ops.fp import FpDevice as JFp
    from wasmsnark_tpu.ops.ntt import NTTDevice as JNTT
    from wasmsnark_tpu.parallel.mesh import make_mesh as jmake_mesh

    m = curve_module("bn128")
    ntt = JNTT(m.ntt_spec, JFp(m.fr_spec))

    @jax.jit
    def four(a):
        return {"fft0": ntt.fft(a), "fft1": ntt.fft(a, odd=True),
                "ifft0": ntt.ifft(a), "ifft1": ntt.ifft(a, odd=True)}

    want = {}
    for bits in sizes:
        for k, v in four(jnp.asarray(ntt_input(bits))).items():
            want[f"{k}_{bits}"] = np.asarray(v)
    assert len(jax.devices()) >= D
    sh = NamedSharding(Mesh(np.array(jax.devices()[:D]), ("d",)),
                       P(None, "d"))
    x = jax.device_put(jnp.asarray(ntt_input(rt_bits)), sh)
    want["rt"] = np.asarray(jax.jit(lambda a: ntt.ifft(ntt.fft(a)),
                                    out_shardings=sh)(x))
    jpk = parse_pkey(pkey, m.fp_spec, m.fr_spec)
    h = JProver(mesh=jmake_mesh(D)).calc_h(jpk, read_witness(wit,
                                                            m.fr_spec))
    assert h.sharding.spec == P(None, "points")
    want["calc_h"] = np.asarray(h)
    return want


def check_ntt(tmp, want, D, bits):
    """Each rank's sharded transforms of ntt_input(bits) are its block of
    the JAX package's, bit for bit."""
    M = (1 << bits) // D
    for r in range(D):
        i = json.loads((tmp / f"ntt{r}.json").read_text())["index"]
        with np.load(tmp / f"ntt{r}.npz") as got:
            for k in ("fft0", "fft1", "ifft0", "ifft1"):
                np.testing.assert_array_equal(
                    got[f"{k}_{bits}"],
                    want[f"{k}_{bits}"][:, i * M:(i + 1) * M],
                    err_msg=f"{k} 2^{bits} rank {r}")


def check_round_trip(tmp, want, D, n_sizes):
    """Each rank's ifft(fft(block)) is its block of the input and of the
    JAX package's sharded round trip, and every sharded transform paid
    three exchanges."""
    x = ntt_input(ROUND_TRIP_BITS)
    M = x.shape[1] // D
    np.testing.assert_array_equal(want["rt"], x)
    for r in range(D):
        meta = json.loads((tmp / f"ntt{r}.json").read_text())
        i = meta["index"]
        with np.load(tmp / f"ntt{r}.npz") as got:
            np.testing.assert_array_equal(
                got["rt"], want["rt"][:, i * M:(i + 1) * M])
        assert meta["exchanges"] == {
            "fft": 3 * (n_sizes + 1), "ifft": 3 * (n_sizes + 1),
            "fft_odd": 3 * n_sizes, "ifft_odd": 3 * n_sizes}, r


def check_calc_h(tmp, want, D, name):
    """Each rank's calc_h is its P(None, axis) block of the JAX prover's
    under make_mesh(D), through the split: four exchanges a CALC_H (the
    prove's and calc_h's)."""
    M = want.shape[1] // D
    for r in range(D):
        rec = json.loads((tmp / f"{name}{r}.json").read_text())
        assert rec["path"] == "sharded" and rec["why"] is None, rec
        assert rec["exchanges"] == {"ifft": 2, "fft_odd": 2, "ifft_2n": 2,
                                    "h_blocks": 2}, rec["exchanges"]
        np.testing.assert_array_equal(np.load(tmp / f"{name}{r}.npy"),
                                      want[:, r * M:(r + 1) * M])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_g1_window_sums_2x4_mesh_match_jax(tmp_path):
    """BN128 G1, N = 42 (not a multiple of 8), c = 4, over make_mesh_2d(2,
    4) with the points on ("host", "points"), as the JAX package's
    test_g1_msm_sharded_2d_mesh: every rank's window sums bit-identical to
    rank 0's, and each window equal (affine) to the JAX package's
    msm_sharded over its 2 x 4 mesh on the same inputs."""
    m = curve_module("bn128")
    R = m.Fr.q
    rnd = random.Random(21)
    n = 42
    pts = [m.G1.times_scalar(m.g1_gen, rnd.randrange(1, R))
           for _ in range(n)]
    scalars = [rnd.randrange(R) for _ in range(n)]
    x, y = _affine_planes(m, "g1", pts)
    s = ints_to_limbs_fast(scalars, m.fr_spec.n_limbs)
    np.savez(tmp_path / "in.npz", x, y, s)
    procs = spawn("g1_2x4", 8, tmp_path)
    try:
        import jax
        import jax.numpy as jnp
        from wasmsnark_tpu.ops.curve import JacobianDevice as JJac
        from wasmsnark_tpu.ops.fp import FpDevice as JFp
        from wasmsnark_tpu.ops.msm import MSMDevice as JMSM
        from wasmsnark_tpu.ops.towers import FpAdapter as JAd
        from wasmsnark_tpu.parallel import mesh as jmesh
        assert len(jax.devices()) >= 8
        run = jmesh.msm_sharded(
            JMSM(JJac(JAd(JFp(m.fp_spec))), window_bits=4),
            jmesh.make_mesh_2d(2, 4), axis=("host", "points"))
        want = [np.asarray(a) for a in run(
            jnp.asarray(s), (jnp.asarray(x), jnp.asarray(y)))]
    finally:
        join(procs, tmp_path)
    got = [_load(tmp_path / f"out{r}.npz") for r in range(8)]
    for r in range(1, 8):
        for a, b in zip(got[r], got[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
    wins = _points(m, "g1", got[0])
    jwins = _points(m, "g1", want)
    assert len(wins) == len(jwins) == got[0][0].shape[-1]
    for w, (a, b) in enumerate(zip(wins, jwins)):
        assert _same(m.G1, a, b), w
    from wasmsnark_tpu_torch.ops.msm import fold_windows
    assert _same(m.G1, fold_windows(m.G1, wins, 4), m.G1.msm(pts, scalars))


@pytest.fixture(scope="module")
def oracle_3(tmp_path_factory, keys):
    """The four ORACLE_CASES and the prove on one spawn of 3 ranks: the
    spawn's directory, and (inputs, outputs per rank) per case."""
    tmp = tmp_path_factory.mktemp("mesh3")
    (tmp / "k3.pkey").write_bytes(keys[0])
    (tmp / "k3.wit").write_bytes(keys[1])
    rnd = random.Random(33)
    cases = []
    for i, (curve, group, n) in enumerate(ORACLE_CASES):
        m = curve_module(curve)
        G = getattr(m, group.upper())
        gen = m.g1_gen if group == "g1" else m.g2_gen
        pts = [G.times_scalar(gen, rnd.randrange(1, m.Fr.q))
               for _ in range(n)]
        scalars = [rnd.randrange(m.Fr.q) for _ in range(n)]
        if n > 2:
            pts[3], scalars[5] = G.zero(), 0
        np.savez(tmp / f"in{i}.npz", *_affine_planes(m, group, pts),
                 ints_to_limbs_fast(scalars, m.fr_spec.n_limbs))
        cases.append((m, G, pts, scalars))
    join(spawn("oracle_3", 3, tmp), tmp)
    return tmp, [(case, [_load(tmp / f"out{i}_{r}.npz") for r in range(3)])
                 for i, case in enumerate(cases)]


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)),
                         ids=[f"{c}-{g}-n{n}" for c, g, n in ORACLE_CASES])
def test_msm_sharded_point_3_ranks_vs_oracle(oracle_3, case):
    """A 1-D mesh of 3 ranks, BN128 G2 (over F2) and BLS12-381 G1, N = 10
    and N = 2 (a rank of padding only): msm_sharded_point equals the
    port's host oracle's msm, the same bits on every rank."""
    (m, G, pts, scalars), outs = oracle_3[1][case]
    for r in (1, 2):
        for a, b in zip(outs[r], outs[0]):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
    group = "g1" if len(outs[0]) == 3 else "g2"
    (got,) = _points(m, group, outs[0])
    assert _same(G, got, G.msm(pts, scalars))


@pytest.fixture(scope="module")
def keys():
    from wasmsnark_tpu.groth16 import setup as jsetup
    from wasmsnark_tpu.groth16.pkey import write_witness
    pkey, vk, _ = jsetup.setup(jsetup.square_chain_circuit(K), seed=1)
    wit = jsetup.square_chain_witness(K, 5)
    return pkey, write_witness(wit, curve_module("bn128").fr_spec)


@pytest.fixture(scope="module")
def jax_proof(keys):
    import wasmsnark_tpu
    pkey, wbytes = keys
    return wasmsnark_tpu.build_bn128().groth16_gen_proof(wbytes, pkey, rng=7)


@pytest.fixture(scope="module")
def ranks_2(tmp_path_factory, keys, request):
    """One spawn of 2 ranks for every 2-rank case, the JAX package's
    results computed meanwhile: (the spawn's directory, those results)."""
    tmp = tmp_path_factory.mktemp("mesh2")
    pkey, wit = keys
    (tmp / "k3.pkey").write_bytes(pkey)
    (tmp / "k3.wit").write_bytes(wit)
    procs = spawn("ranks_2", 2, tmp)
    try:
        want = jax_references(NTT_BITS_2, ROUND_TRIP_BITS, 2, pkey, wit)
        want["proof"] = request.getfixturevalue("jax_proof")
    finally:
        join(procs, tmp)
    return tmp, want


@pytest.mark.parametrize("bits", NTT_BITS_2)
def test_sharded_ntt_2_ranks_matches_jax(ranks_2, bits):
    """ShardedNTT's fft, ifft and their odd forms on 2 ranks (2^2 = D^2
    points among the sizes): each rank's block bit for bit the JAX
    NTTDevice's."""
    check_ntt(*ranks_2, 2, bits)


def test_sharded_round_trip_2_ranks_matches_jax(ranks_2):
    check_round_trip(*ranks_2, 2, len(NTT_BITS_2))


def test_sharded_calc_h_2_ranks_matches_jax(ranks_2):
    """calc_h of square_chain_circuit(3) (a domain of 8) on 2 ranks, split:
    each rank's block of H is the JAX prover's under make_mesh(2)."""
    tmp, want = ranks_2
    check_calc_h(tmp, want["calc_h"], 2, "k3")


def test_prove_on_2_ranks_equals_jax(ranks_2):
    """The prove on a mesh of 2 ranks (c = 4, rng = 7), CALC_H split and H
    passed to the MSM as it is (n_pad is the domain): each rank holds
    only its blocks of the key's point sections, and every rank's proof
    JSON equals the JAX package's byte for byte."""
    tmp, want = ranks_2
    for r in range(2):
        out = json.loads((tmp / f"k3{r}.json").read_text())
        assert out["path"] == "sharded" and not out["recut"], out
        assert out["n_pad"] == out["domain"]
        assert json.dumps(out["proof"]) == json.dumps(want["proof"]), r
        assert out["g1_block"] == -(-out["n_pad"] // 2)
        assert out["b2_block"] < out["n_pad"]


def test_prove_on_3_ranks_whole_calc_h(oracle_3, jax_proof):
    """A mesh of 3 ranks cannot split CALC_H: every rank runs it whole,
    records so with the reason, and still gives the JAX proof."""
    tmp = oracle_3[0]
    for r in range(3):
        out = json.loads((tmp / f"k3{r}.json").read_text())
        assert out["path"] == "whole" and "power of two" in out["why"], out
        assert "exchanges" not in out
        assert json.dumps(out["proof"]) == json.dumps(jax_proof), r


def test_world_of_one_in_process(tmp_path, keys):
    """A world of one rank in the test's own process (gloo, a file
    store): the mesh's proof, CALC_H split over one rank with no
    exchange, equals the unsharded port's, a mesh larger
    than the world is refused, and make_mesh() with no device argument
    needs a card."""
    from wasmsnark_tpu_torch.groth16.prover import Groth16Prover
    pkey, wbytes = keys
    want = Groth16Prover(device=CPU, msm_window_bits=4).prove(
        wbytes, pkey, rng=7)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        prover = Groth16Prover(device=CPU, mesh=mesh, msm_window_bits=4)
        got = prover.prove(wbytes, pkey, rng=7)
        assert prover.calc_h_path == "sharded" and not prover.h_recut
        split = prover._calc_h_split(prover._key(pkey)[0].domain_size)
        assert split.D == 1 and not split.exchanges
        with pytest.raises(ValueError, match="2 ranks"):
            make_mesh(2, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_mesh()
    finally:
        dist.destroy_process_group()
    assert json.dumps(got) == json.dumps(want)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    for make in (lambda: make_mesh(device="cpu"),
                 lambda: make_mesh_2d(2, 4, device="cpu")):
        with pytest.raises(RuntimeError, match="process group"):
            make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


if __name__ == "__main__":
    rank_main(RANK_CASES, sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
              sys.argv[4])
