"""The system under test: wasmsnark_tpu_torch's runtimes, behind the
calls the prove and verify loops make.  A runtime is found by the
configuration's curve (the port's build_<curve>); a loop of another kind
brings its own adapter in its own file."""

from __future__ import annotations


def _runtime(curve: str, device):
    import wasmsnark_tpu_torch as port
    return getattr(port, f"build_{curve}")(device=device)


class PortProver:
    """groth16_gen_proof on the card (api.build_<curve>), with the port's
    trusted setup making the proving key."""

    def __init__(self, curve: str, device=None):
        self.rt = _runtime(curve, device)

    def setup(self, circ, seed: int) -> bytes:
        from wasmsnark_tpu_torch.groth16.setup import R1CS, setup
        pkey, _, _ = setup(R1CS(circ.n_signals, circ.n_public,
                                circ.constraints),
                           seed=seed, module=self.rt.module,
                           device=self.rt.device)
        return pkey

    def prove(self, witness: bytes, pkey: bytes, rng, timings=None) -> dict:
        """rng: a callable n -> n random bytes, the proof's blinding.
        timings: a dict for the prover's synchronized phase seconds."""
        if timings is None:
            return self.rt.groth16_gen_proof(witness, pkey, rng=rng)
        return self.rt.prover.prove(witness, pkey, rng=rng, timings=timings)


class PortVerifier:
    """groth16_verify_batch (groth16/verifier.py) of one curve."""

    def __init__(self, curve: str, device=None):
        self.rt = _runtime(curve, device)

    def verify_batch(self, vk: dict, inputs_list, proofs) -> list:
        return self.rt.groth16_verify_batch(vk, inputs_list, proofs)


def launches() -> int:
    """The port's kernel launches since the last reset (cuda_lib's
    counters; the plain CPU versions launch nothing)."""
    from wasmsnark_tpu_torch.ops import cuda_lib
    return sum(cuda_lib.launches.values())


def reset_launches() -> None:
    from wasmsnark_tpu_torch.ops import cuda_lib
    cuda_lib.reset_launches()
