"""The traffic generator.  A traffic file's "loop" names a module of this
package, loops/<loop>.py, which holds two classes:

    Loop     makes its inputs from the seed, the configuration and the
             traffic file's parameters, runs one operation at a time on
             the program, and compares what the window produced with the
             reference (`check`, which decides `correct`)
    Control  the reference put in the program's place with one guarantee
             of the configuration broken, which `check` has to fail
             (control.py runs it)

so that a new kind of loop is a new file.  The two here:

    prove   one prover, its key resident, proves back to back
    verify  one verifier takes batches of proofs against one key back to
            back

Every draw is made from a stream named by the seed and what it is for
(`stream(seed, what)`), so the same seed gives the same inputs and
operation i the same inputs whatever ran before it."""

from __future__ import annotations

import importlib
import random

# what a malformed answer raises when the comparison reads it
FAULT_TYPES = (ValueError, KeyError, TypeError, IndexError, AttributeError)


def stream(seed: int, what) -> random.Random:
    return random.Random(f"{seed}:{what}")


def module(loop: str):
    """loops/<loop>.py."""
    return importlib.import_module(f"{__name__}.{loop}")
