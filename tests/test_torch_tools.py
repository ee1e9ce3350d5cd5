"""The port's offline CLIs (wasmsnark_tpu_torch/tools: build_pkey,
build_witness, build_pedersen_tables), run as `python -m` modules, against
the JAX package's tools run in-process on the same input: a toy
snarkjs-shaped proving key (4 signals, 1 public input, a domain of 4,
points that are multiples of the BN128 generators, a zero point among
them) and witness built here.  Tolerance: byte-identical outputs.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np

from wasmsnark_tpu.tools import build_pedersen_tables as j_tables
from wasmsnark_tpu.tools import build_pkey as j_pkey
from wasmsnark_tpu.tools import build_witness as j_witness

from wasmsnark_tpu_torch.groth16.pkey import parse_pkey
from wasmsnark_tpu_torch.models.bn128 import bn128

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run_port(tool, *args):
    out = subprocess.run(
        [sys.executable, "-m", f"wasmsnark_tpu_torch.tools.{tool}", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _toy_key(rng):
    m = bn128()
    r = m.fr_spec.q

    def g1(k):
        x, y = m.G1.affine(m.G1.times_scalar(m.g1_gen, k))[:2]
        return [str(x), str(y), "1"]

    def g2(k):
        (x0, x1), (y0, y1) = m.G2.affine(m.G2.times_scalar(m.g2_gen, k))[:2]
        return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]

    def k():
        return int(rng.integers(1, 1 << 62))

    n_vars, n_public, domain = 4, 1, 4

    def pols():
        return [{str(c): str(int.from_bytes(rng.bytes(32), "little") % r)
                 for c in sorted(set(int(v) for v in rng.integers(
                     0, domain, size=2)))} for _ in range(n_vars)]

    pk = {"protocol": "groth", "nVars": n_vars, "nPublic": n_public,
          "domainSize": domain, "polsA": pols(), "polsB": pols(),
          "A": [g1(k()) for _ in range(n_vars)],
          "B1": [g1(k()) for _ in range(n_vars)],
          "B2": [g2(k()) for _ in range(n_vars)],
          "C": [None] * (n_public + 1) + [g1(k()) for _ in range(
              n_vars - n_public - 1)],
          "hExps": [g1(k()) for _ in range(domain)],
          "vk_alfa_1": g1(k()), "vk_beta_1": g1(k()), "vk_delta_1": g1(k()),
          "vk_beta_2": g2(k()), "vk_delta_2": g2(k())}
    pk["A"][3] = ["0", "1", "0"]                    # a zero point
    pk["B2"][2] = [["0", "0"], ["1", "0"], ["0", "0"]]
    return pk


def test_build_pkey_and_witness_against_jax(tmp_path):
    rng = np.random.default_rng(6)
    pk = _toy_key(rng)
    r = bn128().fr_spec.q
    wit = ["1"] + [str(int.from_bytes(rng.bytes(32), "little") % r)
                   for _ in range(3)]
    (tmp_path / "pk.json").write_text(json.dumps(pk))
    (tmp_path / "w.json").write_text(json.dumps(wit))
    for tool, jax_tool, name in (("build_pkey", j_pkey, "pk"),
                                 ("build_witness", j_witness, "w")):
        src = str(tmp_path / f"{name}.json")
        said = _run_port(tool, "-i", src, "-o", str(tmp_path / f"{name}.bin"))
        jax_tool.main(["-i", src, "-o", str(tmp_path / f"{name}_jax.bin")])
        got = (tmp_path / f"{name}.bin").read_bytes()
        assert got == (tmp_path / f"{name}_jax.bin").read_bytes()
        assert said.strip() == f"wrote {len(got)} bytes to " \
                               f"{tmp_path / f'{name}.bin'}"
    key = (tmp_path / "pk.bin").read_bytes()
    m = bn128()
    parsed = parse_pkey(key, m.fp_spec, m.fr_spec)
    assert (parsed.n_signals, parsed.n_public, parsed.domain_size) == (4, 1, 4)
    assert len((tmp_path / "w.bin").read_bytes()) == 4 * 32


def test_build_pedersen_tables_against_jax(tmp_path):
    out = tmp_path / "tables.json"
    _run_port("build_pedersen_tables", "-o", str(out))
    j_tables.main(["-o", str(tmp_path / "tables_jax.json")])
    assert out.read_bytes() == (tmp_path / "tables_jax.json").read_bytes()
    data = json.loads(out.read_text())
    assert len(data["table"]) == 12 and all(len(t) == 4
                                            for t in data["table"])
    assert _run_port("build_pedersen_tables") == out.read_text()
