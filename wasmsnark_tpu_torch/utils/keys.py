"""KeyCache: the one rule for a key's device state.

The prover (groth16/prover.py), the BN128 / BLS12-381 batch verifier
(groth16/verifier.py) and the MNT6753 runtime (models/mnt6753_runtime.py)
each keep what a key costs to prepare (uploaded points, tables, prepared
coefficients) on themselves, in a KeyCache: built once a key, at most
MAX_KEYS keys, and a key past them clears the others before it is built.
"""

from __future__ import annotations

MAX_KEYS = 4


class KeyCache:
    """Per-key state, built on a key's first use and kept by its owner."""

    def __init__(self):
        self._entries: dict = {}

    def get(self, key, build):
        """The state of `key`; on a miss build() makes it, after clearing
        every other key if MAX_KEYS are kept."""
        if key not in self._entries:
            if len(self._entries) >= MAX_KEYS:
                self._entries.clear()
            self._entries[key] = build()
        return self._entries[key]

    def pop(self, key) -> None:
        self._entries.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()

    def values(self):
        return self._entries.values()

    def __len__(self) -> int:
        return len(self._entries)
