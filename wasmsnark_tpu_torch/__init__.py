"""wasmsnark_tpu_torch — the PyTorch/CUDA port of wasmsnark_tpu.

The same Groth16 framework (BN128 and BLS12-381 setup, prove, host verify
and batched device verification) and the MNT6753 Bowe-Gabizon verifier,
with every TPU kernel of those paths rewritten by hand in CUDA C++ for
Hopper (csrc/).  It imports torch and
numpy, never jax and never the JAX package; data crosses the package
boundary in the JAX package's layout (16-bit limb planes [L, *B],
Montgomery form, affine zero (0, 0)).

    build_bn128(device=None) -> Bn128Runtime
    build_bls12381(device=None) -> Bls12381Runtime
        (groth16_gen_proof / groth16_verify / groth16_verify_batch)
    build_mnt6753(device=None) -> Mnt6753Runtime
        (bowe_gabizon_verify_batch / verify / verify_fused / verify_sync)
    build_f1(q, device=None) -> F1Runtime
        (mul / square / add / sub / neg / inverse / divmod / inverse_gcd /
         bench_mul)

Entry points run on the CUDA card unless the caller passes device="cpu",
where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from .api import (build_bls12381, build_bn128, build_f1,  # noqa: F401
                  build_mnt6753)
