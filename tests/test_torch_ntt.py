"""Port parity: NTT (fft, odd-coset fft, ifft) and CALC_H of
wasmsnark_tpu_torch against wasmsnark_tpu on the CPU, bit for bit."""

import jax
import numpy as np
import pytest
import torch

from wasmsnark_tpu.models.bn128 import bn128 as jbn128
from wasmsnark_tpu.ops.fp import FpDevice as JFp
from wasmsnark_tpu.ops.ntt import NTTDevice as JNTT

from wasmsnark_tpu_torch.models.bn128 import bn128 as tbn128
from wasmsnark_tpu_torch.ops import fp as tfp
from wasmsnark_tpu_torch.ops.ntt import NTTDevice as TNTT

# Test workers share the cores: one intra-op thread each keeps the many
# small plain-version ops from contending for them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
_jm, _tm = jbn128(), tbn128()
JF = JFp(_jm.fr_spec)
JN = JNTT(_jm.ntt_spec, JF)
TF = tfp.FpDevice(_tm.fr_spec, CPU)
TN = TNTT(_tm.ntt_spec, TF)


def _input(bits, seed):
    rng = np.random.default_rng(seed)
    q = _jm.Fr.q
    vals = [int.from_bytes(rng.bytes(32), "little") % q
            for _ in range(1 << bits)]
    return JF.pack_mont(vals)


def _jax_transforms(a):
    f, fo = JN.fft(a), JN.fft(a, odd=True)
    return f, fo, JN.ifft(f), JN.ifft(fo, odd=True)


_jax_transforms_jit = jax.jit(_jax_transforms)


@pytest.mark.parametrize("bits", range(1, 11))
def test_fft_ifft_odd_bit_identical(bits):
    x = _input(bits, bits)
    want = [np.asarray(w) for w in _jax_transforms_jit(x)]
    tx = tfp.planes(x, CPU)
    f, fo = TN.fft(tx), TN.fft(tx, odd=True)
    got = [f, fo, TN.ifft(f), TN.ifft(fo, odd=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tfp.to_numpy(g), w)
    np.testing.assert_array_equal(tfp.to_numpy(got[2]), x)   # round trip


def test_calc_h_bit_identical():
    """The H planes of a square-chain circuit (the shape of
    tests/test_groth16_e2e.py) from both provers, same key and witness."""
    from wasmsnark_tpu.groth16.setup import (setup, square_chain_circuit,
                                             square_chain_witness)
    from wasmsnark_tpu.groth16.pkey import parse_pkey, write_witness
    from wasmsnark_tpu.groth16.prover import Groth16Prover as JProver
    from wasmsnark_tpu.groth16.pkey import read_witness
    from wasmsnark_tpu_torch.convert import proving_key_from_numpy
    from wasmsnark_tpu_torch.groth16.prover import Groth16Prover as TProver

    pkey, _, _ = setup(square_chain_circuit(3), seed=1)
    jpk = parse_pkey(pkey, _jm.fp_spec, _jm.fr_spec)
    wit = read_witness(write_witness(square_chain_witness(3, 5),
                                     _jm.fr_spec), _jm.fr_spec)
    want = np.asarray(JProver().calc_h(jpk, wit))
    tp = TProver(CPU)
    got = tp.calc_h(proving_key_from_numpy(jpk), tfp.planes(wit, CPU))
    np.testing.assert_array_equal(tfp.to_numpy(got), want)


@pytest.fixture(scope="module")
def host_fp(tmp_path_factory):
    """The 8-word field library (K1-K4) built by g++ for the host."""
    import shutil
    from test_torch_csrc_host import build_host_libs
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return build_host_libs(tmp_path_factory.mktemp("ntt_host"),
                           only=("fp_kernels_w8",))


@pytest.mark.parametrize("bits,tile_log", [(3, 10), (7, 4), (10, 6),
                                           (11, 10)])
def test_fft_ifft_through_k3_host_build(host_fp, monkeypatch, bits,
                                        tile_log):
    """NTTDevice.fft / ifft as on the card, every pass a launch of K3's
    transform kernel (the host build, through chip_smoke.py's rehearsal
    hooks), with TILE_LOG set to tile_log for the pass split: one pass,
    five, three and two; bit for bit against the JAX package's
    NTTDevice on the same input, with no other kernel launched."""
    from test_torch_csrc_host import rehearse
    from wasmsnark_tpu_torch.ops import cuda_lib, ntt as tntt
    rehearse(monkeypatch, host_fp)
    monkeypatch.setattr(tntt, "TILE_LOG", tile_log)
    x = _input(bits, 100 + bits)
    want = [np.asarray(w) for w in _jax_transforms_jit(x)]
    tx = tfp.planes(x, CPU)
    cuda_lib.reset_launches()
    f, fo = TN.fft(tx), TN.fft(tx, odd=True)
    got = [f, fo, TN.ifft(f), TN.ifft(fo, odd=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tfp.to_numpy(g), w)
    passes = len(tntt.ntt_passes(bits))
    assert passes == {3: 1, 7: 5, 10: 3, 11: 2}[bits]
    assert {k: v for k, v in cuda_lib.launches.items() if v} == {
        "K3": 4 * passes}
    assert cuda_lib.fn_launches["k3_ntt_pass"] == 4 * passes


def test_vector_helpers_and_serialize_limbs_bit_identical():
    """NTTDevice.mul_n, to_mont_n, from_mont_n and serialize_limbs
    (build_fft.js:374-547) against the JAX package's on the same planes."""
    from wasmsnark_tpu.ops.ntt import serialize_limbs as j_serialize
    from wasmsnark_tpu_torch.ops.ntt import serialize_limbs
    a, b = _input(5, 31), _input(5, 32)
    ta, tb = tfp.planes(a, CPU), tfp.planes(b, CPU)
    for got, want in ((TN.mul_n(ta, tb), JN.mul_n(a, b)),
                      (TN.to_mont_n(ta), JN.to_mont_n(a)),
                      (TN.from_mont_n(ta), JN.from_mont_n(a))):
        assert np.array_equal(tfp.to_numpy(got), np.asarray(want))
    vals = [0, 1, _jm.Fr.q - 1, 1 << 200]
    assert np.array_equal(serialize_limbs(vals, 16), j_serialize(vals, 16))
