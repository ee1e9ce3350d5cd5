"""The point-sharded MSM and the sharded prove of wasmsnark_tpu_torch/
parallel/mesh.py on the CPU over gloo, against the JAX package's
msm_sharded, the port's host oracle and the JAX prover.

A rank is a process: each test starts its ranks as subprocesses of this
file run as a script,

    PYTHONPATH=. python tests/test_torch_mesh.py <case> <rank> <world> <dir>

which meet through a file store in the test's temporary directory (so
test workers cannot clash on ports) and write their results there.  The
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
    """msm_sharded_point over a 1-D mesh of 3 ranks, each ORACLE_CASES."""
    mesh = make_mesh(device="cpu")
    for i, (curve, group, _) in enumerate(ORACLE_CASES):
        planes = _load(tmp / f"in{i}.npz")
        s = planes.pop()
        pts = (planes[0], planes[1]) if group == "g1" else (
            (planes[0], planes[1]), (planes[2], planes[3]))
        _, Gd = _group_device(curve, group)
        run = msm_sharded_point(MSMDevice(Gd, window_bits=4), mesh)
        _save(tmp / f"out{i}_{rank}.npz",
              map_leaf(run(s, pts), lambda a: a[..., None]))


def _rank_prove_2(rank, tmp):
    """The BN128 prove on a mesh of 2 ranks, c = 4, rng = 7."""
    from wasmsnark_tpu_torch.groth16.prover import Groth16Prover
    pkey = (tmp / "pkey.bin").read_bytes()
    prover = Groth16Prover(device="cpu", mesh=make_mesh(device="cpu"),
                           msm_window_bits=4)
    proof = prover.prove((tmp / "wit.bin").read_bytes(), pkey, rng=7)
    _, _, dev = prover._keys[id(pkey)]
    (tmp / f"out{rank}.json").write_text(json.dumps({
        "proof": proof, "n_pad": dev["n_pad"],
        "g1_block": dev["g1"][0].shape[-1],
        "b2_block": dev["points_b2"][0][0].shape[-1]}))


RANK_CASES = {"g1_2x4": _rank_g1_2x4, "oracle_3": _rank_oracle_3,
              "prove_2": _rank_prove_2}


def _rank_main(case, rank, world, tmp):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        RANK_CASES[case](rank, pathlib.Path(tmp))
    finally:
        dist.destroy_process_group()


def _spawn(case, world, tmp):
    """Start the `world` ranks of `case`; returns their processes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, case, str(r), str(world),
                 str(tmp)], env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def _join(procs, tmp):
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
    procs = _spawn("g1_2x4", 8, tmp_path)
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
        _join(procs, tmp_path)
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
def oracle_3(tmp_path_factory):
    """The four ORACLE_CASES on one spawn of 3 ranks: (inputs, outputs
    per rank) per case."""
    tmp = tmp_path_factory.mktemp("mesh3")
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
    _join(_spawn("oracle_3", 3, tmp), tmp)
    return [(case, [_load(tmp / f"out{i}_{r}.npz") for r in range(3)])
            for i, case in enumerate(cases)]


@pytest.mark.parametrize("case", range(len(ORACLE_CASES)),
                         ids=[f"{c}-{g}-n{n}" for c, g, n in ORACLE_CASES])
def test_msm_sharded_point_3_ranks_vs_oracle(oracle_3, case):
    """A 1-D mesh of 3 ranks, BN128 G2 (over F2) and BLS12-381 G1, N = 10
    and N = 2 (a rank of padding only): msm_sharded_point equals the
    port's host oracle's msm, the same bits on every rank."""
    (m, G, pts, scalars), outs = oracle_3[case]
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


def test_prove_on_2_ranks_equals_jax(tmp_path, keys):
    """The prove on a mesh of 2 ranks (c = 4, rng = 7): each rank holds
    only its blocks of the key's point sections, and every rank's proof
    JSON equals the JAX package's byte for byte."""
    pkey, wbytes = keys
    (tmp_path / "pkey.bin").write_bytes(pkey)
    (tmp_path / "wit.bin").write_bytes(wbytes)
    procs = _spawn("prove_2", 2, tmp_path)
    try:
        import wasmsnark_tpu
        want = wasmsnark_tpu.build_bn128().groth16_gen_proof(
            wbytes, pkey, rng=7)
    finally:
        _join(procs, tmp_path)
    for r in range(2):
        out = json.loads((tmp_path / f"out{r}.json").read_text())
        assert json.dumps(out["proof"]) == json.dumps(want), r
        assert out["g1_block"] == -(-out["n_pad"] // 2)
        assert out["b2_block"] < out["n_pad"]


def test_world_of_one_in_process(tmp_path, keys):
    """A world of one rank in the test's own process (gloo, a file
    store): the mesh's proof equals the unsharded port's, a mesh larger
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
        got = Groth16Prover(device=CPU, mesh=mesh, msm_window_bits=4).prove(
            wbytes, pkey, rng=7)
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
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
