"""Batched prime-field arithmetic on limb planes, PyTorch port of
wasmsnark_tpu/ops/fp.py (FpDevice).

Layout: a field element is a column of 16-bit limbs, limb-major, so a batch
is a tensor [L, *B] — the JAX package's layout.  The port holds planes as
int32 tensors (the limbs are < 2^16, so the bits are those of the JAX
package's uint32 planes): PyTorch's uint32 tensors lack the indexing and
arithmetic that the glue code needs on both devices.  `planes()` and
`to_numpy()` convert at the package boundary.

`batch_inv`, `FpSqrt` (the Euler criterion and the uniform Tonelli-
Shanks root of the JAX package), `FpDynamic` (per-lane exponents) and
`times_scalar_device` (per-lane scalars on any curve device) compose the
field ops.

Each kernel wrapper below (mont_mul = K1, mod_add / mod_sub = K2) launches
its CUDA kernel on a CUDA tensor and runs its plain PyTorch version on a CPU
tensor.  The plain versions compute in int64 with 16-bit limbs, exactly as
the JAX package's jnp path does in uint32, and are what the CPU tests and
chip_smoke.py hold the kernels against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.spec import FieldSpec, LIMB_BITS, LIMB_MASK
from ..utils import serialize
from . import cuda_lib

DTYPE = torch.int32


# ---------------------------------------------------------------------------
# devices and planes
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """`None` means the card.  Asking for CUDA where there is none raises:
    the port never carries on on the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wasmsnark_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain versions")
    return dev


def planes(a, device) -> torch.Tensor:
    """uint32 limb planes (numpy or tensor) -> int32 tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=DTYPE)
    arr = np.array(a, dtype=np.uint32, copy=True)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(t) -> np.ndarray:
    """int32 limb-plane tensor -> uint32 numpy planes (JAX package layout)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def broadcast_shapes(*shapes) -> tuple:
    """torch.broadcast_shapes for shapes of plain ints, without its
    symbolic-shape machinery (a third of the plain path's host time at
    small batches)."""
    out = [1] * max(len(s) for s in shapes)
    for s in shapes:
        for i, d in enumerate(s, len(out) - len(s)):
            if d != 1 and d != out[i]:
                if out[i] != 1:
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def lanes(L: int, *ts):
    """Broadcast [L, *B_i] planes to one batch shape, aligning the batch
    dims right of the limb axis (a constant [L, 1] against [L, G, B]), and
    flatten to contiguous [L, n].  Returns (flat tensors, batch shape)."""
    bshape = broadcast_shapes(*[t.shape[1:] for t in ts])
    out = []
    for t in ts:
        if t.shape[0] != L:
            raise ValueError(f"expected {L} limb planes, got {t.shape[0]}")
        if t.shape[1:] != bshape:
            t = t.reshape((L,) + (1,) * (len(bshape) - t.dim() + 1)
                          + tuple(t.shape[1:])).expand((L,) + tuple(bshape))
        out.append(t.contiguous().reshape(L, -1))
    return out, tuple(bshape)


def check_cuda(*ts):
    """What a kernel takes: int32 (or bool flags), contiguous, one device."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev or not t.is_cuda:
            raise ValueError("kernel inputs must lie on one CUDA device")
        if t.dtype not in (DTYPE, torch.bool):
            raise TypeError(f"kernel inputs must be int32 planes, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


# ---------------------------------------------------------------------------
# plain versions (int64, 16-bit limbs; any device)
#
# Carry and borrow chains are resolved without a loop over the limbs: a few
# parallel carry rounds bring every column to <= 2^16, then one carry-
# lookahead over the limbs' generate/propagate bits (packed into one int64
# per lane) gives every limb its carry-in at once.  Montgomery reduction is
# the full-width form: m = (T mod R) * (-q^-1) mod R, then (T + m*q) / R.
# ---------------------------------------------------------------------------

_consts: dict = {}


def _const64(key, device, make):
    k = (key, str(device))
    t = _consts.get(k)
    if t is None:
        t = _consts[k] = make().to(device)
    return t


def _q_col(spec: FieldSpec, device):
    return _const64(("q", spec.q), device, lambda: torch.tensor(
        spec.q_limbs, dtype=torch.int64)[:, None])


def _nprime_col(spec: FieldSpec, device):
    """-q^{-1} mod R as 16-bit limbs [L, 1]."""
    def make():
        R = 1 << (LIMB_BITS * spec.n_limbs)
        v = (-pow(spec.q, -1, R)) % R
        return torch.tensor([(v >> (LIMB_BITS * i)) & LIMB_MASK
                             for i in range(spec.n_limbs)],
                            dtype=torch.int64)[:, None]
    return _const64(("np", spec.q), device, make)


def _lookahead(g, p):
    """Carry (or borrow) chain over limbs from generate bits g and
    propagate bits p (int64 0/1 rows [K, n], disjoint).  Up to 61 limbs
    pack into one int64 per lane; longer chains (the 96 limbs of a 48-limb
    product) run in blocks, the carry out of one block entering the next
    as the generate bit of a leading zero limb.
    Returns (carry into each limb [K, n], carry out of the top [n])."""
    K = g.shape[0]
    if K > 61:
        lo, cout = _lookahead(g[:60], p[:60])
        z = torch.zeros_like(cout)[None]
        hi, cout = _lookahead(torch.cat([cout[None], g[60:]]),
                              torch.cat([z, p[60:]]))
        return torch.cat([lo, hi[1:]]), cout
    shifts = _const64(("sh", K), g.device, lambda: torch.arange(
        K, dtype=torch.int64)[:, None])
    G = (g << shifts).sum(0)
    A = G | (p << shifts).sum(0)
    C = (A + G) ^ A ^ G                      # bit k: carry into limb k
    return (C[None] >> shifts) & 1, (C >> K) & 1


def normalize_plain(x):
    """Carry-propagate int64 columns [K, n] (each >= 0) to 16-bit limbs.
    Carry rounds run until every column is below 2^17 - 1, so a column
    that carries a bit (>= 2^16) cannot also pass one on (low limb 2^16 -
    1): the lookahead's generate and propagate bits are disjoint.
    Returns (limbs int64 [K, n], carry out int64 [n])."""
    top = torch.zeros_like(x[0])
    hi = x >> LIMB_BITS
    while x.shape[1] and int(x.max()) >= 2 * LIMB_MASK + 1:
        x = x & LIMB_MASK
        x[1:] += hi[:-1]
        top = top + hi[-1]
        hi = x >> LIMB_BITS
    lo = x & LIMB_MASK
    cin, cout = _lookahead(hi, (lo == LIMB_MASK).long())
    return (lo + cin) & LIMB_MASK, top + cout


def _sub_limbs(x, y):
    """x - y over normalized 16-bit limbs -> (diff limbs, borrow out)."""
    d = x - y
    bin_, bout = _lookahead((d < 0).long(), (d == 0).long())
    return (d - bin_) & LIMB_MASK, bout


def cond_sub_q_plain(spec: FieldSpec, x):
    """x - q if x >= q else x (int64 limbs, normalized)."""
    d, borrow = _sub_limbs(x, _q_col(spec, x.device))
    return torch.where(borrow.bool()[None], x, d)


def _columns(x, y):
    """Product columns of limb vectors x [L, n], y [L, n or 1]:
    S[k] = sum_{i+j=k} x_i*y_j, [2L-1, n] int64.  One float64 matrix
    product against the sliding windows of y (an unfold of y padded by
    L - 1 zeros each side): every term is below 2^32, so a column of L
    terms stays below 2^53 and its float64 sum is exact in any order."""
    L = x.shape[0]
    w = torch.nn.functional.pad(y.t().double(), (L - 1, L - 1)).unfold(
        1, L, 1)                                      # [n or 1, 2L-1, L]
    xf = x.t().flip(1).double()                       # [n, L]
    if y.shape[1] == 1:
        T = xf @ w[0].t()
    else:
        T = torch.bmm(w, xf[:, :, None])[:, :, 0]
    return T.long().t()


# limb products per chunk of lanes in mont_mul_plain: its [n, 2L-1, L]
# float64 windows are cut into pieces of at most ~8 GiB (at 2^16 lanes, a
# stacked MNT6753 Miller step holds ~2.4M lanes of 48 limbs)
_PLAIN_PRODUCTS = 1 << 29


def mont_mul_plain(spec: FieldSpec, x, y):
    """x*y*R^-1 mod q on [L, n] planes (the value the JAX package's CIOS
    computes; canonical results are unique)."""
    L = spec.n_limbs
    cap = max(1, _PLAIN_PRODUCTS // (L * L))
    n = x.shape[1]
    if n > cap:
        return torch.cat([mont_mul_plain(
            spec, x[:, k:k + cap], y if y.shape[1] == 1 else y[:, k:k + cap])
            for k in range(0, n, cap)], dim=1)
    x = x.long()
    y = y.long()
    T = _columns(x, y)                                # [2L-1, n]
    t_lo, _ = normalize_plain(T[:L])                  # T mod R
    m, _ = normalize_plain(_columns(t_lo, _nprime_col(spec, x.device))[:L])
    U = T + _columns(m, _q_col(spec, x.device))
    U, _ = normalize_plain(torch.cat([U, torch.zeros_like(U[:1])]))
    # U = T + m*q: its low L limbs are 0, its high L limbs are < 2q
    return cond_sub_q_plain(spec, U[L:]).to(DTYPE)


def mod_add_plain(spec: FieldSpec, x, y):
    s, _ = normalize_plain(x.long() + y.long())
    return cond_sub_q_plain(spec, s).to(DTYPE)


def mod_sub_plain(spec: FieldSpec, x, y):
    d, borrow = _sub_limbs(x.long(), y.long())
    d, _ = normalize_plain(d + borrow[None] * _q_col(spec, x.device))
    return d.to(DTYPE)


def mul_small_plain(spec: FieldSpec, x, k: int):
    """k x mod q for canonical [L, n] planes and a small static k >= 0 in
    one pass: the limbs times k with one carry pass into a spare limb, then
    conditional subtracts of q 2^j for j from bitlen(k) - 1 down (the value
    of a chain of k - 1 modular adds)."""
    L = spec.n_limbs
    x = x.long()
    v, _ = normalize_plain(torch.cat([x * k, torch.zeros_like(x[:1])]))
    for j in range(max(k.bit_length(), 1) - 1, -1, -1):
        qj = _const64(("qj", spec.q, j), x.device, lambda: torch.tensor(
            [((spec.q << j) >> (LIMB_BITS * i)) & LIMB_MASK
             for i in range(L + 1)], dtype=torch.int64)[:, None])
        d, borrow = _sub_limbs(v, qj)
        v = torch.where(borrow.bool()[None], v, d)
    return v[:L].to(DTYPE)


# ---------------------------------------------------------------------------
# kernel wrappers: K1 (mont_mul), K2 (mod_add, mod_sub)
# ---------------------------------------------------------------------------

def _binary(fn: str, plain, spec: FieldSpec, x, y):
    (xf, yf), bshape = lanes(spec.n_limbs, x, y)
    if not xf.is_cuda:
        out = plain(spec, xf, yf)
    else:
        check_cuda(xf, yf)
        out = torch.empty_like(xf)
        cuda_lib.launch(fn, spec, (xf, yf, out), (xf.shape[1],))
    return out.reshape((spec.n_limbs,) + bshape)


def mont_mul(spec: FieldSpec, x, y):
    """K1: Montgomery product (replaces fp_pallas.py mont_mul_pallas)."""
    return _binary("k1_mont_mul", mont_mul_plain, spec, x, y)


def mod_add(spec: FieldSpec, x, y):
    """K2: (x + y) mod q (replaces fp_pallas.py mod_add_pallas)."""
    return _binary("k2_mod_add", mod_add_plain, spec, x, y)


def mod_sub(spec: FieldSpec, x, y):
    """K2: (x - y) mod q (replaces fp_pallas.py mod_sub_pallas)."""
    return _binary("k2_mod_sub", mod_sub_plain, spec, x, y)


# ---------------------------------------------------------------------------
# FpDevice
# ---------------------------------------------------------------------------

class FpDevice:
    """Batched kernels for one prime field on one device."""

    def __init__(self, spec: FieldSpec, device=None):
        self.spec = spec
        self.L = spec.n_limbs
        self.device = resolve_device(device)
        self.r2_t = self._const(spec.limbs(spec.R2))
        self.one_mont_t = self._const(spec.limbs(spec.one_mont))

    def _const(self, limbs):
        return torch.tensor(list(limbs), dtype=DTYPE,
                            device=self.device)[:, None]

    # -- host <-> device marshalling ----------------------------------------

    def pack(self, values) -> torch.Tensor:
        """list[int] (canonical) -> [L, B] planes on the device."""
        return planes(serialize.ints_to_limbs(values, self.L), self.device)

    def unpack(self, arr) -> list[int]:
        return serialize.limbs_to_ints(to_numpy(arr) if isinstance(
            arr, torch.Tensor) else np.asarray(arr))

    def pack_mont(self, values) -> torch.Tensor:
        s = self.spec
        return planes(serialize.ints_to_limbs_fast(
            [s.to_mont(v) for v in values], self.L), self.device)

    def unpack_mont(self, arr) -> list[int]:
        s = self.spec
        return [s.from_mont(v) for v in self.unpack(arr)]

    # -- carries ----------------------------------------------------------------

    def normalize(self, x):
        """Full carry propagation of int64 columns [L, *B] to 16-bit limbs.
        Returns (limbs int32 [L, *B], carry out int64 [*B])."""
        flat = x.long().reshape(self.L, -1)
        out, c = normalize_plain(flat)
        return out.to(DTYPE).reshape(x.shape), c.reshape(x.shape[1:])

    def reduce_wide_sum(self, acc):
        """Reduce column sums of Montgomery elements mod q (the JAX
        package's reduce_wide_sum): acc [L, *B] int64, column k holding
        the carry-free sum of limb k of < 2^16 elements.  After carry
        normalization the value is lo + carry*2^(16L); lo is brought below
        q by descending conditional subtracts of 2^j*q, and carry*2^(16L)
        mod q = montmul(carry, R^2)."""
        lo, carry = self.normalize(acc)
        lo = lo.long().reshape(self.L, -1)
        J = LIMB_BITS * self.L - self.spec.q.bit_length()
        for j in range(J, -1, -1):
            shifted = self.spec.q << j
            plane = torch.tensor(
                [(shifted >> (LIMB_BITS * i)) & LIMB_MASK
                 for i in range(self.L)], dtype=torch.int64,
                device=lo.device)[:, None].expand_as(lo)
            d, borrow = _sub_limbs(lo, plane)
            lo = torch.where(borrow.bool()[None], lo, d)
        lo = lo.to(DTYPE).reshape(acc.shape)
        c_elem = torch.zeros_like(lo)
        c_elem[0] = carry.to(DTYPE)
        return self.add(lo, self.mont_mul(c_elem, self.r2_t))

    # -- ring ops ---------------------------------------------------------------

    def add(self, x, y):
        return mod_add(self.spec, x, y)

    def sub(self, x, y):
        return mod_sub(self.spec, x, y)

    def neg(self, x):
        """(-x) mod q with -0 = 0: (0 - x) mod q."""
        return mod_sub(self.spec, torch.zeros_like(x), x)

    def mont_mul(self, x, y):
        return mont_mul(self.spec, x, y)

    def mont_sqr(self, x):
        return mont_mul(self.spec, x, x)

    def to_mont(self, x):
        return self.mont_mul(x, self.r2_t)

    def from_mont(self, x):
        one = torch.zeros_like(self.r2_t)
        one[0, 0] = 1
        return self.mont_mul(x, one)

    # -- predicates ---------------------------------------------------------------

    def is_zero(self, x):
        return (x == 0).all(dim=0)

    def eq(self, x, y):
        return (x == y).all(dim=0)

    def select(self, mask, a, b):
        return torch.where(mask[None], a, b)

    # -- exponentiation / inversion -------------------------------------------

    def mont_pow_const(self, x, e: int):
        """x^e for Montgomery-form x, static exponent (MSB-first
        square-and-multiply; the JAX package's ladder computes the same
        canonical value)."""
        r = self.one_mont(*x.shape[1:]).clone()
        for bit in bin(e)[2:]:
            r = self.mont_sqr(r)
            if bit == "1":
                r = self.mont_mul(r, x)
        return r

    def mont_inv(self, x):
        """Batched inversion via Fermat, x^(q-2); 0 maps to 0."""
        return self.mont_pow_const(x, self.spec.q - 2)

    def batch_inv(self, xs):
        """Simultaneous inversion (Montgomery's trick, the JAX package's
        batch_inv): same-shape Montgomery elements inverted with one Fermat
        ladder and 3(K - 1) products.  Zero inputs invert to zero; a masked
        substitution by one keeps them out of the shared product chain.
        Returns the list of inverses."""
        xs = list(xs)
        if len(xs) == 1:
            return [self.mont_inv(xs[0])]
        one = self.one_mont(*xs[0].shape[1:])
        zmask = [self.is_zero(x) for x in xs]
        safe = [self.select(m, one, x) for m, x in zip(zmask, xs)]
        pref = [safe[0]]
        for x in safe[1:]:
            pref.append(self.mont_mul(pref[-1], x))
        u = self.mont_inv(pref[-1])
        out = [None] * len(xs)
        for i in range(len(xs) - 1, 0, -1):
            out[i] = self.mont_mul(u, pref[i - 1])
            u = self.mont_mul(u, safe[i])
        out[0] = u
        return [self.select(m, torch.zeros_like(o), o)
                for m, o in zip(zmask, out)]

    # -- constants ----------------------------------------------------------------

    def one_mont(self, *batch):
        return self.one_mont_t.reshape(
            (self.L,) + (1,) * len(batch)).expand((self.L,) + tuple(batch))


# ---------------------------------------------------------------------------
# per-lane ladders (f1m_exp / timesScalar parity): every lane its own scalar
# ---------------------------------------------------------------------------

def _scalar_bits_msb(scalar_limbs, n_bits: int):
    """[Ls, *B] 16-bit limb planes -> int64 [n_bits, *B] bits, most
    significant first (bits at or above 16 Ls are 0).  The shifts run in
    int64: the CPU has no `>>` on uint32 tensors."""
    s = scalar_limbs.long()
    rows = []
    for k in range(n_bits - 1, -1, -1):
        li, off = divmod(k, LIMB_BITS)
        rows.append((s[li] >> off) & 1 if li < s.shape[0]
                    else torch.zeros_like(s[0]))
    return torch.stack(rows, dim=0)


class FpDynamic:
    """Per-lane exponentiation on an FpDevice (the JAX package's FpDynamic,
    f1m_exp parity): every lane raises its base to its own exponent by an
    MSB-first ladder; each step squares, multiplies (two K1 launches on
    the card) and keeps the product where the lane's bit is 1."""

    def __init__(self, fp: FpDevice):
        self.fp = fp

    def exp(self, x, exp_limbs, n_bits=None):
        """x [L, *B] Montgomery, exp_limbs [Ls, *B] canonical 16-bit planes
        -> x^e per lane (Montgomery)."""
        F = self.fp
        e = planes(exp_limbs, x.device)
        bits = _scalar_bits_msb(e, n_bits or e.shape[0] * LIMB_BITS)
        r = F.one_mont(*x.shape[1:])
        for bit in bits:
            r = F.mont_sqr(r)
            r = F.select(bit != 0, F.mont_mul(r, x), r)
        return r


def times_scalar_device(curve, points, scalar_limbs, n_bits=None):
    """Batched double-and-add (g1m_timesScalar semantics): every lane
    multiplies its point by its own scalar, MSB first; each step doubles
    (K7 on a kernel-backed G1), adds the point (K6) and keeps the sum where
    the lane's bit is 1.  The complete group law folds in zero points and
    zero scalars.  points: (X, Y, Z) leaves [.., *B]; scalar_limbs
    [Ls, *B]."""
    like = points[0]
    while isinstance(like, tuple):
        like = like[0]
    s = planes(scalar_limbs, like.device)
    bits = _scalar_bits_msb(s, n_bits or s.shape[0] * LIMB_BITS)
    acc = curve.zero_like(points)
    for bit in bits:
        acc = curve.double(acc)
        acc = curve.select(bit != 0, curve.add(acc, points), acc)
    return acc


class FpSqrt:
    """Batched Euler criterion and Tonelli-Shanks square root (the JAX
    package's FpSqrt, f1m_isSquare / f1m_sqrt parity): the data-dependent
    loop of the reference becomes a fixed ladder of s - 1 rounds with
    per-lane masked updates, round i squaring i times.  The root is
    normalised to an even canonical value, and sqrt(0) = 0."""

    def __init__(self, fp: FpDevice):
        self.fp = fp
        s, t, z, _ = fp.spec._tonelli
        self.s, self.t = s, t
        self.c0 = fp.pack_mont([z])             # nqr^t, [L, 1]

    def is_square(self, x):
        """Euler criterion on Montgomery-form x -> bool [*B] (0 counts as a
        square)."""
        F = self.fp
        p = F.mont_pow_const(x, (F.spec.q - 1) // 2)
        return F.eq(p, F.one_mont(*x.shape[1:])) | F.is_zero(x)

    def sqrt(self, x):
        """A square root of Montgomery-form x where is_square holds (other
        lanes hold garbage; callers mask), Montgomery form."""
        F = self.fp
        # one ladder for both seeds (t odd): u = x^((t-1)/2), r = u x =
        # x^((t+1)/2), b = r u = x^t
        u = F.mont_pow_const(x, (self.t - 1) // 2)
        r = F.mont_mul(u, x)
        b = F.mont_mul(r, u)
        c = self.c0.reshape((F.L,) + (1,) * (x.dim() - 1)).expand(x.shape)
        one = F.one_mont(*x.shape[1:])
        for i in range(self.s - 2, -1, -1):
            d = b
            for _ in range(i):
                d = F.mont_sqr(d)
            not_one = ~F.eq(d, one)
            r = F.select(not_one, F.mont_mul(r, c), r)
            c = F.mont_sqr(c)
            b = F.select(not_one, F.mont_mul(b, c), b)
        odd = (F.from_mont(r)[0] & 1) != 0
        r = F.select(odd, F.neg(r), r)
        return F.select(F.is_zero(x), x, r)


class PlainFp(FpDevice):
    """FpDevice whose ring ops are the plain versions on any device: the
    field under the plain versions of the curve kernels (ops/curve.py),
    so that chip_smoke.py can hold K5-K7 against pure PyTorch on the
    card."""

    def _plain(self, plain, x, y):
        (xf, yf), bshape = lanes(self.L, x, y)
        return plain(self.spec, xf, yf).reshape((self.L,) + bshape)

    def add(self, x, y):
        return self._plain(mod_add_plain, x, y)

    def sub(self, x, y):
        return self._plain(mod_sub_plain, x, y)

    def neg(self, x):
        return self._plain(mod_sub_plain, torch.zeros_like(x), x)

    def mont_mul(self, x, y):
        return self._plain(mont_mul_plain, x, y)

    def mont_sqr(self, x):
        return self._plain(mont_mul_plain, x, x)
