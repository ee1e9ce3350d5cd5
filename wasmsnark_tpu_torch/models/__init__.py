"""Host curve modules (the oracle assemblies of the JAX package's models/)."""


def curve_module(curve: str):
    """The host module of a curve: "bn128", "bls12381" or "mnt6753"."""
    if curve == "bn128":
        from .bn128 import bn128
        return bn128()
    if curve == "bls12381":
        from .bls12381 import bls12381
        return bls12381()
    if curve == "mnt6753":
        from .mnt6753 import mnt6753
        return mnt6753()
    raise ValueError(f"unknown curve {curve!r}")
