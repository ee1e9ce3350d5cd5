"""The benchmark's own tests: `python -m pytest snarkbench/tests -q` from
the root of the repository (CPU; the card's test is marked `cuda` and
skips without one)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (runs snarkbench/run.py); "
        "skipped elsewhere")
