"""The port stands alone: wasmsnark_tpu_torch and chip_smoke.py import
neither jax nor wasmsnark_tpu, build nothing at import time, run the plain
versions only for CPU tensors, and refuse to fall back to the CPU."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "wasmsnark_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "wasmsnark_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_imports_without_jax_load_no_reference_module():
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(ROOT)!r})
import wasmsnark_tpu_torch
for mod in pkgutil.walk_packages(wasmsnark_tpu_torch.__path__,
                                 "wasmsnark_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
from wasmsnark_tpu_torch.ops import cuda_lib
assert not cuda_lib._libs, "a kernel library was loaded at import"
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "wasmsnark_tpu" or m.startswith("wasmsnark_tpu.")]
assert loaded == ["jax"] and sys.modules["jax"] is None, loaded
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _cpu_operands():
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.ops import fp
    m = bn128()
    F = fp.FpDevice(m.fp_spec, "cpu")
    x = F.pack_mont([1, 2, 3, 4])
    y = F.pack_mont([5, 6, 7, 8])
    return m, x, y


def test_wrappers_on_cpu_tensors_launch_nothing():
    from wasmsnark_tpu_torch.ops import (cuda_lib, curve, fp, ntt, towers,
                                         tower_kernels as tk)
    m, x, y = _cpu_operands()
    Fq, Fr = m.fp_spec, m.fr_spec
    cuda_lib.reset_launches()
    fp.mont_mul(Fq, x, y)
    fp.mod_add(Fq, x, y)
    fp.mod_sub(Fq, x, y)
    ntt.butterfly(Fr, x, y[:, :2])
    towers.mod_cneg(Fq, torch.tensor([True, False, True, False]), x)
    curve.jac_madd(Fq, (x, y, x), (x, y))
    curve.jac_add(Fq, (x, y, x), (y, x, y))
    curve.jac_double(Fq, (x, y, x))
    f = tk.unflatten12([x, y] * 6)
    tk.f12_mul(Fq, f, f)
    tk.f12_sqr(Fq, f)
    tk.f12_cyc_sqr(Fq, f)
    tk.miller_dbl(Fq, (x, y), (y, x), (x, x), x, y)
    tk.miller_add(Fq, (x, y), (y, x), (x, x), (y, y), (x, y), x, y)
    tk.miller_dbl_mtwist(Fq, (x, y), (y, x), (x, x), x, y)
    tk.miller_add_mtwist(Fq, (x, y), (y, x), (x, x), (y, y), (x, y), x, y)
    assert all(v == 0 for v in cuda_lib.launches.values()), cuda_lib.launches
    assert all(v == 0 for v in cuda_lib.fn_launches.values())
    assert cuda_lib.lane_launches == {}
    assert sorted(cuda_lib.launches, key=lambda k: int(k[1:])) == \
        [f"K{i}" for i in range(1, 15)]


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.groth16.setup import setup, square_chain_circuit
    from wasmsnark_tpu_torch.models.bn128 import bn128
    from wasmsnark_tpu_torch.ops.fp import FpDevice
    with pytest.raises(RuntimeError, match="CUDA"):
        wasmsnark_tpu_torch.build_bn128()
    with pytest.raises(RuntimeError, match="CUDA"):
        setup(square_chain_circuit(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        FpDevice(bn128().fp_spec)
    assert wasmsnark_tpu_torch.build_bn128(device="cpu").device.type == "cpu"


def test_bls_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.ops.pairing import bls12381_pairing_device
    with pytest.raises(RuntimeError, match="CUDA"):
        wasmsnark_tpu_torch.build_bls12381()
    with pytest.raises(RuntimeError, match="CUDA"):
        bls12381_pairing_device()
    rt = wasmsnark_tpu_torch.build_bls12381(device="cpu")
    assert rt.device.type == "cpu" and rt.prover.Fp.L == 24
    assert rt.F1.q == rt.module.F1.q            # passthrough to the module


@pytest.mark.parametrize("rel", [
    "models/bls12381.py", "models/bls12381_constants.py",
    "models/__init__.py", "ops/pairing.py", "ops/tower_kernels.py",
    "groth16/runtime.py"])
def test_bls_modules_import_no_jax(rel):
    """The slice's new and extended modules exist and import neither jax
    nor the JAX package (the subprocess test above imports them with jax
    blocked)."""
    path = PORT / rel
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(tops) & {"jax", "jaxlib", "wasmsnark_tpu"}, rel


def test_k11_entry_points_and_per_word_libraries():
    """K11 is registered beside K1-K10; every source builds once per word
    count its kernels serve (the field kernels at 8, 12 and 24, the curve
    and F12 tower kernels at 8 and 12, the MNT6753 kernels at 24 only), and
    a field of another width is refused before any build."""
    from wasmsnark_tpu_torch.ops import cuda_lib
    from wasmsnark_tpu_torch.fields.spec import FieldSpec
    assert cuda_lib.KERNELS["K11"] == (
        "tower_kernels", ("k11_miller_dbl_mtwist", "k11_miller_add_mtwist"))
    assert cuda_lib._SIGNATURES["k11_miller_dbl_mtwist"] == (3, 3)
    assert cuda_lib._SIGNATURES["k11_miller_add_mtwist"] == (4, 3)
    assert cuda_lib.WORDS == (8, 12, 24)
    assert {lib: ws for lib, (_, ws) in cuda_lib.SOURCES.items()} == {
        "fp_kernels": (8, 12, 24), "curve_kernels": (8, 12),
        "tower_kernels": (8, 12), "mnt_kernels": (24,)}
    assert sorted(cuda_lib.libraries()) == sorted(
        [f"{name}_w{w}" for name in ("fp_kernels", "curve_kernels",
                                     "tower_kernels") for w in (8, 12)]
        + ["fp_kernels_w24", "mnt_kernels_w24"])
    text = (pathlib.Path(cuda_lib.CSRC) / "tower_kernels.cu").read_text()
    for fn in ("k11_miller_dbl_mtwist", "k11_miller_add_mtwist"):
        body = text[text.index(f"int {fn}("):]
        assert body.index("#if WORDS == 12") < body.index("}")
    wide = FieldSpec((1 << 1000) + 1, "wide")      # 64 limbs: no build
    x = torch.zeros((wide.n_limbs, 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no kernel build for 64 limbs"):
        cuda_lib.launch("k1_mont_mul", wide, (x, x, x), (1,))
    mnt = FieldSpec((1 << 752) + 1155, "mnt-width")  # 48 limbs
    y = torch.zeros((mnt.n_limbs, 1), dtype=torch.int32)
    for fn in ("k8_f12_mul", "k5_jac_madd"):       # no 24-word build
        with pytest.raises(RuntimeError, match="no kernel build for 48"):
            cuda_lib.launch(fn, mnt, (y, y, y), (1,))
    assert not cuda_lib._libs


def test_mnt_entry_points_and_modules():
    """K12-K14 are registered with their C signatures; build_mnt6753 and
    the MNT6753 engines need a card unless told the CPU."""
    from wasmsnark_tpu_torch.ops import cuda_lib
    assert cuda_lib.KERNELS["K12"] == ("mnt_kernels",
                                       ("k12_f6_mul", "k12_f6_sqr"))
    assert cuda_lib.KERNELS["K13"] == ("mnt_kernels", ("k13_f6_cyc_sqr",))
    assert cuda_lib.KERNELS["K14"] == (
        "mnt_kernels", ("k14_mnt_miller_dbl", "k14_mnt_miller_add"))
    if torch.cuda.is_available():
        return
    import wasmsnark_tpu_torch
    from wasmsnark_tpu_torch.models.mnt6753_device import mnt6753_device
    from wasmsnark_tpu_torch.ops.pairing import mnt6753_pairing_device
    for make in (wasmsnark_tpu_torch.build_mnt6753, mnt6753_pairing_device,
                 mnt6753_device):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    rt = wasmsnark_tpu_torch.build_mnt6753(device="cpu")
    assert rt.device.type == "cpu" and rt._pd.fp.L == 48


@pytest.mark.parametrize("rel", [
    "models/mnt6753.py", "models/mnt6753_constants.py",
    "models/mnt6753_device.py", "models/mnt6753_runtime.py",
    "csrc/mnt_kernels.cu", "csrc/team.cuh"])
def test_mnt_modules_exist_and_import_no_jax(rel):
    """The slice's new files exist; its Python modules import neither jax
    nor the JAX package, and the constants are the JAX package's, byte for
    byte."""
    path = PORT / rel
    assert path.exists()
    if rel.endswith(".py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert (node.module or "").split(".")[0] not in (
                    "jax", "jaxlib", "wasmsnark_tpu"), rel
            if isinstance(node, ast.Import):
                assert not {a.name.split(".")[0] for a in node.names} & {
                    "jax", "jaxlib", "wasmsnark_tpu"}, rel
    if rel == "models/mnt6753_constants.py":
        assert path.read_bytes() == (
            ROOT / "wasmsnark_tpu" / rel).read_bytes()


def test_loader_builds_only_on_demand_and_matches_sources(tmp_path,
                                                         monkeypatch):
    """nvcc is looked for only inside build(); every C entry point's
    parameters match the ctypes argtypes the loader declares; the build
    directory's hash covers every source."""
    from wasmsnark_tpu_torch.ops import cuda_lib
    from wasmsnark_tpu_torch.models.bn128 import bn128
    assert set(cuda_lib.SOURCES) == {"fp_kernels", "curve_kernels",
                                     "tower_kernels", "mnt_kernels"}
    assert {cuda_lib._ENTRY[fn][1] for fn in cuda_lib._SIGNATURES} == \
        set(cuda_lib.KERNELS)
    assert len(cuda_lib.source_hash()) == 16
    assert cuda_lib.build_dir().startswith(cuda_lib.BUILD_ROOT)
    if cuda_lib.shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_lib.build()
        assert not cuda_lib._libs
    ctype = {"const void*": "p", "void*": "p", "long long": "q", "int": "i"}
    for lib, (src, _) in cuda_lib.SOURCES.items():
        text = (pathlib.Path(cuda_lib.CSRC) / src).read_text()
        for fn, (n_ptr, n_int) in cuda_lib._SIGNATURES.items():
            if cuda_lib._ENTRY[fn][0] != lib:
                continue
            mt = re.search(r"int %s\(([^)]*)\)" % fn, text)
            assert mt, fn
            kinds = "".join(
                ctype[re.sub(r"\s+\w+$", "", a.strip())]
                for a in mt.group(1).split(","))
            assert kinds == "p" * n_ptr + "q" * n_int + "ipp", (fn, kinds)
    # the kernels' field constants: q and R mod q words, -q^-1 mod 2^32
    for spec in (bn128().fp_spec, bn128().fr_spec):
        w = cuda_lib.field_words(spec)
        assert w.dtype == np.uint32 and len(w) == 17
        q = sum(int(v) << (32 * k) for k, v in enumerate(w[:8]))
        one = sum(int(v) << (32 * k) for k, v in enumerate(w[8:16]))
        assert q == spec.q and one == spec.one_mont
        assert (q * int(w[16]) + 1) % (1 << 32) == 0
    before = cuda_lib.source_hash()
    names = cuda_lib.HEADERS + tuple(src for src, _ in
                                     cuda_lib.SOURCES.values())
    for name in names:
        (tmp_path / name).write_bytes(
            (pathlib.Path(cuda_lib.CSRC) / name).read_bytes())
    monkeypatch.setattr(cuda_lib, "CSRC", str(tmp_path))
    assert cuda_lib.source_hash() == before
    for name in names:
        text = (tmp_path / name).read_bytes()
        (tmp_path / name).write_bytes(text + b"\n")
        assert cuda_lib.source_hash() != before, name
        (tmp_path / name).write_bytes(text)


def test_chip_smoke_without_a_card_fails_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
