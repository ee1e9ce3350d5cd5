"""The benchmark's plain reference: Groth16 over BN128 and BLS12-381 in
plain Python integers, a frozen copy of the pairing oracles the port was
checked against at bring-up.  It imports nothing of the program under
test, and takes nothing the program made: the verifying key, the expected
proofs and every verdict are worked out here again from the circuit and
the setup's trapdoor, which the benchmark draws from the run's seed."""

import importlib


def curve(name: str):
    """The reference of a configuration's "curve": BN128 and BLS12-381
    from pairing.py, any other from its own module, reference/<name>.py,
    whose `curve()` gives it."""
    from . import pairing
    if name in pairing.PARAMS:
        return pairing.curve(name)
    return importlib.import_module(f"{__name__}.{name}").curve()
