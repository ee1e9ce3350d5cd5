"""Scaled-down configurations and traffic for the CPU tests: the
configurations' own files with fewer constraints and narrower packed
inputs, so that the port's plain CPU versions prove in seconds."""

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as fh:
        return json.load(fh)


def prove_cfg(constraints: int = 96) -> dict:
    return dict(load("configs", "zcash_sapling_spend"),
                constraints=constraints, operand_window=16,
                public_inputs=[{"name": "x", "bits": None},
                               {"name": "y", "bits": None},
                               {"name": "p", "bits": 6},
                               {"name": "q", "bits": 2}])


def prove_traffic() -> dict:
    return dict(load("traffic", "prove_closed"), witness_pool=2)


def verify_cfg() -> dict:
    return load("configs", "tornado_withdraw")


def verify_traffic() -> dict:
    return dict(load("traffic", "verify_batch"), batch=12, batches=3,
                bases=4, tampered={"point": 1, "input": 1, "noncanonical": 2},
                pairing_sample=2)
