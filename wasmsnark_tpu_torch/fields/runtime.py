"""F1Runtime, the analogue of the reference's `buildF1(q)` (src/f1.js),
PyTorch port of wasmsnark_tpu/fields/runtime.py.

Every method takes and returns lists of Python ints (canonical values) and
runs batched on the device: mul, square, add, sub, neg and inverse over the
field kernels K1 and K2 (f1 semantics, build_f1.js:44-76: canonical in and
out, the product a Montgomery product with an R^2 fix-up), divmod and
inverse_gcd over ops/bigint.py, and `bench_mul(n)`, the throughput of
chained Montgomery products (test_F1, src/f1.js:123-132).

On the card a field whose word count has no prebuilt library builds the
field kernels at that width at its first launch (ops/cuda_lib.py); the
plain versions run only on the CPU.
"""

from __future__ import annotations

import random
import time

import torch

from .spec import FieldSpec, LIMB_BITS
from ..ops.bigint import int_div, inverse_mod
from ..ops.fp import FpDevice


class F1Runtime:
    def __init__(self, q: int, device=None):
        self.q = q
        self.spec = FieldSpec(q, "f1")
        if q >> (LIMB_BITS * self.spec.n_limbs - 1):
            # a + b < 2q must fit the limbs, as the kernels' adds need
            raise ValueError(f"q needs a spare top bit in its "
                             f"{self.spec.n_limbs} 16-bit limbs")
        self.F = FpDevice(self.spec, device)
        self.device = self.F.device

    # -- canonical-form batched API -----------------------------------------

    def mul(self, xs, ys):
        F = self.F
        return F.unpack(F.mont_mul(F.to_mont(F.pack(xs)), F.pack(ys)))

    def square(self, xs):
        """x^2 mod q, canonical (f1_square is f1_mul(x, x)); the JAX
        package's square returns x^2 R mod q, a Montgomery-form value."""
        F = self.F
        x = F.pack(xs)
        return F.unpack(F.mont_mul(F.to_mont(x), x))

    def add(self, xs, ys):
        return self.F.unpack(self.F.add(self.F.pack(xs), self.F.pack(ys)))

    def sub(self, xs, ys):
        return self.F.unpack(self.F.sub(self.F.pack(xs), self.F.pack(ys)))

    def neg(self, xs):
        return self.F.unpack(self.F.neg(self.F.pack(xs)))

    def inverse(self, xs):
        """x^-1 by Fermat's ladder (0 -> 0)."""
        F = self.F
        return F.unpack(F.from_mont(F.mont_inv(F.to_mont(F.pack(xs)))))

    # -- big-integer tier -----------------------------------------------------

    def divmod(self, xs, ys):
        """True integer divmod per lane (int_div, src/build_int.js:710-924);
        values need not be below q, anything fitting the limbs works."""
        qt, rt = int_div(self.F.pack(xs), self.F.pack(ys))
        return self.F.unpack(qt), self.F.unpack(rt)

    def inverse_gcd(self, xs):
        """x^-1 mod q by binary extended GCD (int_inverseMod parity,
        src/build_int.js:926-1054): valid for any odd q, prime or not;
        non-units give 0."""
        x = self.F.pack(xs)
        m = torch.tensor(self.spec.q_limbs, dtype=x.dtype,
                         device=x.device)[:, None].expand_as(x)
        return self.F.unpack(inverse_mod(x, m))

    # -- benchmark loop (test_F1 parity, src/f1.js:123-132) -------------------

    def bench_mul(self, n: int, batch: int = 1 << 16) -> dict:
        """Run at least n Montgomery products on the device: `reps` chained
        batched products y <- y x, one K1 launch each on the card, timed
        between CUDA events after a warm-up chain (host clock on the CPU).
        Returns {"muls", "seconds", "muls_per_sec"}."""
        rng = random.Random(0)
        x = self.F.pack([rng.randrange(self.q) for _ in range(batch)])
        reps = max(1, n // batch)

        def chain():
            y = x
            for _ in range(reps):
                y = self.F.mont_mul(y, x)
            return y

        chain()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain()
            dt = time.perf_counter() - t0
        total = reps * batch
        return {"muls": total, "seconds": dt, "muls_per_sec": total / dt}
