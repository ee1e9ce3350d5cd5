"""The device's peak allocated memory over the window (after a reset of
the peak at its start), in GiB."""


def read(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
