"""Proofs given a verdict over the window's whole time, tampered lanes
included."""


def read(rec):
    lanes = sum(op.lanes for op in rec.done)
    return lanes / rec.window_s if lanes else None
