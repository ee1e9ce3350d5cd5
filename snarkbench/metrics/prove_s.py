"""Seconds a proof: the window's whole time over the proofs it
completed."""


def read(rec):
    return rec.window_s / len(rec.done) if rec.done else None
