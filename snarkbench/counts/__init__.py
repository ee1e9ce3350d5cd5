"""The frozen yardstick: operations and bytes that each layer's work
needs, as functions of its input sizes alone (point counts, scalar
widths, domain sizes, lanes, the field's 32-bit word count), never of
which kernels run or how often they launch; and the card's peaks.

An operation is a 32-bit integer multiply-add counted as 2 (a CIOS
Montgomery product of w words: 2 (2 w^2 + w) + w), a modular add or sub
3 w.  Bytes count each input read once and each output written once, in
the program's layout (16-bit limbs in int32: 4 bytes a limb, 2 limbs a
word).  The copies of chip_smoke.py's k5_ops, k6_ops, k7_ops, ntt_ops
and bound, taken at their general lanes, are in curve.py and ntt.py."""

# NVIDIA H100 SXM at its 700 W limit: the data sheet's HBM bandwidth, and
# the 32-bit integer multiply-add rate: compute capability 9.0 issues 64
# of them a clock an SM (the CUDA C++ Programming Guide's throughput
# table), half its 128 float32 FMAs, so half the data sheet's 67 TFLOP/s.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12 * 64 / 128


def mm(w: int) -> int:
    """Operations of one Montgomery product of w-word elements."""
    return 2 * (2 * w * w + w) + w


def add(w: int) -> int:
    """Operations of one modular add or sub."""
    return 3 * w


def elem_bytes(w: int) -> int:
    return 8 * w


def least_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the integer rate."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS)

