"""Port parity for the plain versions of K12-K14 (MNT6753, L = 48): the F6
product and square, the Granger-Scott cyclotomic square and the Miller
doubling and mixed-add steps of wasmsnark_tpu_torch/ops/tower_kernels.py
against the JAX package.

The references are the JAX package's own formulas — `F2Device(F3Device)`
of ops/towers.py, `gs_cyclotomic_square`, and tower_pallas.py
`mnt_dbl_formula` / `mnt_add_formula`, the functions its Pallas kernels
run — driven by an integer base adapter (Python ints mod q, canonical), so
they compute in milliseconds what the JAX 48-limb device path compiles for
minutes; and its host oracle's F6.  Montgomery form is a ring isomorphism,
so the port's Montgomery outputs, read back to canonical values, must
equal the adapter's values exactly (tolerance 0).  Inputs: seeded random
values with the edge values 0, 1, q-1, q-2; Z = 0 lanes and x2 = X/Z
lanes for the Miller steps; cyclotomic elements (the easy part of random
F6 values) for K13.
"""

import random

import pytest
import torch

from wasmsnark_tpu.models.mnt6753 import mnt6753 as jmnt
from wasmsnark_tpu.ops.tower_pallas import mnt_add_formula, mnt_dbl_formula
from wasmsnark_tpu.ops.towers import F2Device, F3Device, gs_cyclotomic_square

from wasmsnark_tpu_torch.models.mnt6753 import mnt6753
from wasmsnark_tpu_torch.ops import cuda_lib, fp as tfp
from wasmsnark_tpu_torch.ops import tower_kernels as tk

torch.set_num_threads(1)

CPU = torch.device("cpu")
jm, m = jmnt(), mnt6753()
spec = m.fp_spec
Q = spec.q
F = tfp.FpDevice(spec, CPU)
N = 8                                          # lanes


class IntBase:
    """The base-field protocol of the JAX package's towers over Python ints
    mod q (canonical values, one lane)."""

    def mul(self, a, b):
        return a * b % Q

    def square(self, a):
        return a * a % Q

    def add(self, a, b):
        return (a + b) % Q

    def sub(self, a, b):
        return (a - b) % Q

    def neg(self, a):
        return -a % Q

    def mul_small(self, a, k):
        return a * k % Q

    def zero_like(self, a):
        return 0

    def one_like(self, a):
        return 1

    def inv(self, a):
        return pow(a, -1, Q) if a else 0


BASE = IntBase()
F3 = F3Device(BASE, lambda a: BASE.mul_small(a, 11))


def MULV(a):
    return (BASE.mul_small(a[2], 11), a[0], a[1])


F6 = F2Device(F3, MULV)


def _vals(seed):
    rng = random.Random(seed)
    return [0, 1, Q - 1, Q - 2] + [rng.randrange(Q) for _ in range(N - 4)]


def _pack(tree):
    """Nested tuples of per-lane int lists -> Montgomery planes [L, N]."""
    if isinstance(tree, tuple):
        return tuple(_pack(t) for t in tree)
    return F.pack_mont(tree)


def _unpack(tree):
    if isinstance(tree, tuple):
        return tuple(_unpack(t) for t in tree)
    return F.unpack_mont(tree)


def _lane(tree, b):
    if isinstance(tree, tuple):
        return tuple(_lane(t, b) for t in tree)
    return tree[b]


def _f6(seed):
    return tuple(tuple(_vals(seed + 3 * i + j) for j in range(3))
                 for i in range(2))


def _f3(seed):
    return tuple(_vals(seed + j) for j in range(3))


def test_f6_mul_and_square():
    a, b = _f6(10), _f6(20)
    got_mul = _unpack(tk.mnt_f6_mul_plain(spec, _pack(a), _pack(b)))
    got_sqr = _unpack(tk.mnt_f6_sqr_plain(spec, _pack(a)))
    for lane in range(N):
        al, bl = _lane(a, lane), _lane(b, lane)
        assert _lane(got_mul, lane) == F6.mul(al, bl) == jm.F6.mul(al, bl)
        assert _lane(got_sqr, lane) == F6.square(al) == jm.F6.square(al)


def test_cyclotomic_square_on_cyclotomic_elements():
    rng = random.Random(30)
    cyc = []
    for _ in range(N):
        f = tuple(tuple(rng.randrange(1, Q) for _ in range(3))
                  for _ in range(2))
        t = jm.F6.mul(jm.F6.conjugate(f), jm.F6.inv(f))
        cyc.append(jm.F6.mul(jm._frobenius6(t), t))
    planes = _pack(tuple(tuple([c[i][j] for c in cyc] for j in range(3))
                         for i in range(2)))
    got = _unpack(tk.mnt_f6_cyc_sqr_plain(spec, planes))
    for lane, c in enumerate(cyc):
        want = gs_cyclotomic_square(BASE, lambda x: BASE.mul_small(x, 11), c)
        assert _lane(got, lane) == want == jm.F6.square(c)


def _points():
    """(X, Y, Z, x2, y2, xP, yP) per-lane ints: Z = 0 in lanes 4-5, x2 =
    X/Z in lanes 6-7 (where the add step's lambda vanishes)."""
    X, Y, Z, x2, y2 = (_f3(40 + 3 * k) for k in range(5))
    xP, yP = _vals(60), _vals(61)
    for c in Z:
        c[4] = c[5] = 0
    for lane in (6, 7):
        xz = jm.F3.mul(_lane(X, lane), jm.F3.inv(_lane(Z, lane)))
        for k in range(3):
            x2[k][lane] = xz[k]
    return X, Y, Z, x2, y2, xP, yP


@pytest.mark.parametrize("step", ["dbl", "add"])
def test_miller_steps_against_the_jax_formulas(step):
    X, Y, Z, x2, y2, xP, yP = _points()
    if step == "dbl":
        got = tk.mnt_miller_dbl_plain(spec, *_pack((X, Y, Z, xP, yP)))
    else:
        got = tk.mnt_miller_add_plain(spec,
                                      *_pack((X, Y, Z, x2, y2, xP, yP)))
    got = _unpack(got)
    for lane in range(N):
        L = [_lane(v, lane) for v in (X, Y, Z, x2, y2, xP, yP)]
        if step == "dbl":
            want = mnt_dbl_formula(BASE, F3, MULV, *L[:3], *L[5:])
        else:
            want = mnt_add_formula(BASE, F3, MULV, *L)
        assert _lane(got, lane) == want
    if step == "add":
        (a0, _), *_ = got
        assert all(a0[k][lane] == 0 for k in range(3) for lane in (6, 7))


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    """On CPU tensors each wrapper is its plain version and launches
    nothing; a batch shape is kept."""
    a, b = _pack(_f6(70)), _pack(_f6(80))
    X, Y, Z, x2, y2, xP, yP = _pack(_points())
    cuda_lib.reset_launches()
    pairs = [
        (tk.mnt_f6_mul(spec, a, b), tk.mnt_f6_mul_plain(spec, a, b)),
        (tk.mnt_f6_sqr(spec, a), tk.mnt_f6_sqr_plain(spec, a)),
        (tk.mnt_f6_cyc_sqr(spec, a), tk.mnt_f6_cyc_sqr_plain(spec, a)),
        (tk.mnt_miller_dbl(spec, X, Y, Z, xP, yP),
         tk.mnt_miller_dbl_plain(spec, X, Y, Z, xP, yP)),
        (tk.mnt_miller_add(spec, X, Y, Z, x2, y2, xP, yP),
         tk.mnt_miller_add_plain(spec, X, Y, Z, x2, y2, xP, yP))]
    for got, want in pairs:
        assert _unpack(got) == _unpack(want)
    assert all(v == 0 for v in cuda_lib.launches.values())
    a3 = tuple(tuple(c.reshape(spec.n_limbs, 2, N // 2) for c in h)
               for h in a)
    out = tk.mnt_f6_sqr(spec, a3)
    assert out[0][0].shape == (spec.n_limbs, 2, N // 2)
    assert _unpack(tuple(tuple(c.reshape(spec.n_limbs, N) for c in h)
                         for h in out)) == _unpack(
        tk.mnt_f6_sqr_plain(spec, a))
