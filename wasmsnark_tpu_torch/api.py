"""Top-level runtime constructors (reference API parity: index.js:20-22).

    reference                         wasmsnark_tpu_torch
    ---------                         -------------------
    await buildBn128()                build_bn128()          (CUDA card)
                                      build_bn128(device="cpu")
    await buildBls12381()             build_bls12381()       (CUDA card)
                                      build_bls12381(device="cpu")
    await buildMnt6753()              build_mnt6753()        (CUDA card)
                                      build_mnt6753(device="cpu")
    await buildF1(q)                  build_f1(q)            (CUDA card)
                                      build_f1(q, device="cpu")
    bn128.groth16GenProof(w, pk)      rt.groth16_gen_proof(witness, pkey)
    bn128.groth16Verify(vk, in, prf)  rt.groth16_verify(vk, inputs, proof)
                                      rt.groth16_verify_batch(vk, inputs_list,
                                                              proofs)
    mnt6753.verify(vk, in, prf)       rt.verify(vk, inputs, proof)
    mnt6753.verifyFused(vk, in, prf)  rt.verify_fused(vk, inputs, proof)
    mnt6753.verifySync(vk, in, prf)   rt.verify_sync(vk, inputs, proof)
                                      rt.bowe_gabizon_verify_batch(
                                          vk, inputs_list, proofs)
"""

from __future__ import annotations


def build_bn128(device=None):
    """BN128 Groth16 runtime on `device` (default: the CUDA card; raises
    where there is none)."""
    from .groth16.runtime import Bn128Runtime
    return Bn128Runtime(device)


def build_bls12381(device=None):
    """BLS12-381 Groth16 runtime on `device` (default: the CUDA card;
    raises where there is none), with attribute passthrough to the curve
    module."""
    from .groth16.runtime import Bls12381Runtime
    return Bls12381Runtime(device)


def build_mnt6753(device=None):
    """MNT6753 Bowe-Gabizon verifier runtime on `device` (default: the CUDA
    card; raises where there is none)."""
    from .models.mnt6753_runtime import Mnt6753Runtime
    return Mnt6753Runtime(device)


def build_f1(q: int, device=None):
    """Single-field runtime over the odd modulus q on `device` (default:
    the CUDA card; raises where there is none): batched canonical mul,
    square, add, sub, neg, inverse, divmod, inverse_gcd and bench_mul.  On
    the card a q whose word count has no prebuilt library builds the field
    kernels at that width at its first launch."""
    from .fields.runtime import F1Runtime
    return F1Runtime(q, device)
