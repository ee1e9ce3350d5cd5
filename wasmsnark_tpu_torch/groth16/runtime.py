"""Bn128 and Bls12381 runtimes, PyTorch port of
wasmsnark_tpu/groth16/runtime.py — the analogue of the reference's `Bn128`
class (src/bn128.js), and the same surface over BLS12-381.

    rt = wasmsnark_tpu_torch.build_bn128()          # on the CUDA card
    rt = wasmsnark_tpu_torch.build_bls12381()       # on the CUDA card
    proof = rt.groth16_gen_proof(witness_bytes, pkey_bytes)
    ok    = rt.groth16_verify(vk_json, public_inputs, proof_json)
    oks   = rt.groth16_verify_batch(vk_json, inputs_list, proofs)
"""

from __future__ import annotations

from ..models import curve_module
from .verifier import Groth16BatchVerifier
from .verifier import groth16_verify as _verify


class Groth16Runtime:
    """Prover and verifiers of one curve (CURVE) on one torch device."""

    CURVE = ""

    def __init__(self, device=None):
        from .prover import Groth16Prover
        self.module = curve_module(self.CURVE)
        self.prover = Groth16Prover(device, curve=self.CURVE)
        self.device = self.prover.device
        self.verifier = Groth16BatchVerifier(self.CURVE, self.device)

    # -- prover (src/bn128.js:580-720) ---------------------------------------
    def groth16_gen_proof(self, witness, pkey, *, rng=None):
        """witness: bytes (flat LE n8-byte Fr values, tools/buildwitness.js
        format) or list[int]; pkey: bytes in tools/buildpkey.js layout, or
        a parsed ProvingKey.  Returns {pi_a, pi_b, pi_c} with decimal-string
        coordinates."""
        return self.prover.prove(witness, pkey, rng=rng)

    # -- verifier (src/bn128.js:722-791) --------------------------------------
    def groth16_verify(self, verification_key, inputs, proof) -> bool:
        return _verify(verification_key, inputs, proof, curve=self.CURVE)

    def groth16_verify_batch(self, verification_key, inputs_list,
                             proofs) -> list:
        """Verify N proofs in one pass through the device pairing, on the
        runtime's device (lanes = proofs); see
        groth16.verifier.Groth16BatchVerifier.verify."""
        return self.verifier.verify(verification_key, inputs_list, proofs)


class Bn128Runtime(Groth16Runtime):
    CURVE = "bn128"


class Bls12381Runtime(Groth16Runtime):
    """The same Groth16 surface over BLS12-381 (the reference builds the
    bls12381 module but wires no prover for it).  Attribute access falls
    through to the curve module, so this object also serves as
    `bls12381()` (fields, curves, pairing oracle)."""

    CURVE = "bls12381"

    def __getattr__(self, name):
        if name == "module":            # not set yet: no recursion
            raise AttributeError(name)
        return getattr(self.module, name)
