"""Set-up: process start to the window's first operation (imports, the
kernels' load or build, circuit, witnesses or proofs, trusted setup, key
upload, one warm operation)."""


def read(rec):
    return rec.setup_s
