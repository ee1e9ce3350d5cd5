// K12-K14: the extension-tower and Miller-step kernels of the MNT6753
// pairing, for Hopper (sm_90a).
//
// K12 k12_f6_mul / k12_f6_sqr replace wasmsnark_tpu/ops/tower_pallas.py
//     _f6_mul_kernel (square=False / True): F6 = F3[w]/(w^2 - v) Karatsuba
//     product (3 F3 products of 6 base products each) and square (2 F3
//     products: the F2-over-F3 square of towers.py F2Device.square, not
//     the product of a with itself).
// K13 k13_f6_cyc_sqr replaces tower_pallas.py _mnt_f6_cyc_kernel: the
//     Granger-Scott cyclotomic square over the Fp base (9 base squarings),
//     the polynomial map of wasmsnark_tpu/ops/towers.py gs_cyclotomic_square
//     with the non-residue 11.
// K14 k14_mnt_miller_dbl / k14_mnt_miller_add replace tower_pallas.py
//     _mnt_mdbl_kernel / _mnt_madd_kernel: the Miller doubling and mixed-add
//     steps on the a != 0 twist over F3 (tower_pallas.py mnt_dbl_formula,
//     mnt_add_formula), writing the line (a0, b) at P and the new point.
//     The new point's projective representative is not unique, so these
//     compute exactly the products of those formulas, product for product.
//
// Towers: F3 = Fp[v]/(v^3 - 11), F6 = F3[w]/(w^2 - v); multiplication by
// the non-residue 11 is fp.cuh's double-and-add chain of 6 modular adds
// (the JAX package adds 10 times; the canonical value is the same).  The library is
// built only at N = 24 words (MNT6753's 753-bit Fq, 48 16-bit limbs): the
// CIOS bound of fp.cuh, q < 2^(32N - 2) = 2^766, holds.  Every value is
// canonical (< q), so the results are bit-identical to the 16-bit-limb
// plain versions and the JAX package.
//
// Layout: an operand is one [k, L, n] tensor, component c of lane i at limb
// j sitting at p[(c * L + j) * n + i] (fp.cuh ld/st): an F6 element is its 6
// planes (a0, a1, a2, b0, b1, b2), a Miller point (X, Y, Z) 9 planes, an
// affine twist point (x2, y2) 6, the G1 point (xP, yP) 2; the Miller steps
// write 15 planes (a0, b, X', Y', Z').
//
// What bounds them on the H100: counted against the card's peaks, K14's
// doubling (108 Montgomery products of ~2N^2 = 1,152 wide multiply-adds)
// needs more time for its operations than for its 26 planes of 2N words
// per lane, and K12's product about as much for both.  One F6 operand is
// 6N = 144 words and a Miller point 9N = 216, more than the 255 registers
// of a thread, so: one thread per lane as K8-K11; the base product is one
// __noinline__ copy of the CIOS body, the F3 product is __noinline__ too,
// and the kernels read their inputs from device memory where a formula
// needs them again instead of keeping them live.  The call boundaries cost spills that -Xptxas -v
// reports (the build log); splitting one product over several threads is
// later work.

// The one copy of the CIOS product here (fmul) keeps its outer loop rolled:
// on the H100 that builds this library ~10 s faster with K12-K14 within
// 10 % either way (chip_cios_unroll.py, PERF.md §6).
#define FP_CIOS_ROLLED
#include "fp.cuh"

namespace {

constexpr int kMntThreads = 64;
constexpr int kNR = 11;            // F3 non-residue, G1's a, G2's a2 / v^2

template <int N>
struct F3 {
  Fe<N> c0, c1, c2;
};

// -- base field ------------------------------------------------------------------

template <int N>
__device__ __noinline__ Fe<N> fmul(const Field<N>& f, const Fe<N>& a,
                                   const Fe<N>& b) {
  return mont_mul(f, a, b);
}

// -- F3 --------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ F3<N> f3_add(const Field<N>& f, const F3<N>& a,
                                        const F3<N>& b) {
  return {add(f, a.c0, b.c0), add(f, a.c1, b.c1), add(f, a.c2, b.c2)};
}

template <int N>
__device__ __forceinline__ F3<N> f3_sub(const Field<N>& f, const F3<N>& a,
                                        const F3<N>& b) {
  return {sub(f, a.c0, b.c0), sub(f, a.c1, b.c1), sub(f, a.c2, b.c2)};
}

template <int N>
__device__ __forceinline__ F3<N> f3_small(const Field<N>& f, const F3<N>& a,
                                          int k) {
  return {mul_small(f, a.c0, k), mul_small(f, a.c1, k),
          mul_small(f, a.c2, k)};
}

// v * a = (11 a2, a0, a1)
template <int N>
__device__ __forceinline__ F3<N> f3_mulv(const Field<N>& f, const F3<N>& a) {
  return {mul_small(f, a.c2, kNR), a.c0, a.c1};
}

// v^2 * a = (11 a1, 11 a2, a0)
template <int N>
__device__ __forceinline__ F3<N> f3_mulv2(const Field<N>& f, const F3<N>& a) {
  return {mul_small(f, a.c1, kNR), mul_small(f, a.c2, kNR), a.c0};
}

// a * s for s in Fp: 3 base products
template <int N>
__device__ __forceinline__ F3<N> f3_scal(const Field<N>& f, const F3<N>& a,
                                         const Fe<N>& s) {
  return {fmul(f, a.c0, s), fmul(f, a.c1, s), fmul(f, a.c2, s)};
}

// Karatsuba over the cubic extension, 6 base products (build_f3m.js,
// towers.py F3Device.mul):
// c0 = v0 + 11 (t12 - v1 - v2), c1 = (t01 - v0 - v1) + 11 v2,
// c2 = (t02 - v0 - v2) + v1.
template <int N>
__device__ __noinline__ F3<N> f3_mul(const Field<N>& f, const F3<N>& a,
                                     const F3<N>& b) {
  Fe<N> v0 = fmul(f, a.c0, b.c0);
  Fe<N> v1 = fmul(f, a.c1, b.c1);
  Fe<N> v2 = fmul(f, a.c2, b.c2);
  Fe<N> t01 = fmul(f, add(f, a.c0, a.c1), add(f, b.c0, b.c1));
  Fe<N> t12 = fmul(f, add(f, a.c1, a.c2), add(f, b.c1, b.c2));
  Fe<N> t02 = fmul(f, add(f, a.c0, a.c2), add(f, b.c0, b.c2));
  return {add(f, v0, mul_small(f, sub(f, sub(f, t12, v1), v2), kNR)),
          add(f, sub(f, sub(f, t01, v0), v1), mul_small(f, v2, kNR)),
          add(f, sub(f, sub(f, t02, v0), v2), v1)};
}

// -- F6 = F3[w]/(w^2 - v) ------------------------------------------------------------

// F3 half h (0 or 1) of a stacked F6 operand: components 3h .. 3h + 2
template <int N>
__device__ __forceinline__ F3<N> ld3(const uint32_t* __restrict__ p, int c,
                                     int64_t n, int64_t i) {
  return {ld<N>(p, c, n, i), ld<N>(p, c + 1, n, i), ld<N>(p, c + 2, n, i)};
}

template <int N>
__device__ __forceinline__ void st3(uint32_t* __restrict__ p, int c, int64_t n,
                                    int64_t i, const F3<N>& a) {
  st<N>(p, c, n, i, a.c0);
  st<N>(p, c + 1, n, i, a.c1);
  st<N>(p, c + 2, n, i, a.c2);
}

// -- K12 --------------------------------------------------------------------------

// (a0 + a1 w)(b0 + b1 w) = (m0 + v m1) + ((a0 + a1)(b0 + b1) - (m0 + m1)) w
template <int N>
__global__ void __launch_bounds__(kMntThreads)
    f6_mul_kernel(Field<N> f, const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  int64_t n) {
  LANE_LOOP(i, n) {
    F3<N> m0 = f3_mul(f, ld3<N>(a, 0, n, i), ld3<N>(b, 0, n, i));
    F3<N> m1 = f3_mul(f, ld3<N>(a, 3, n, i), ld3<N>(b, 3, n, i));
    st3<N>(out, 0, n, i, f3_add(f, m0, f3_mulv(f, m1)));
    F3<N> t = f3_mul(f, f3_add(f, ld3<N>(a, 0, n, i), ld3<N>(a, 3, n, i)),
                     f3_add(f, ld3<N>(b, 0, n, i), ld3<N>(b, 3, n, i)));
    st3<N>(out, 3, n, i, f3_sub(f, t, f3_add(f, m0, m1)));
  }
}

// (a0 + a1 w)^2: ab = a0 a1, t = (a0 + a1)(a0 + v a1);
// c0 = t - (ab + v ab), c1 = 2 ab
template <int N>
__global__ void __launch_bounds__(kMntThreads)
    f6_sqr_kernel(Field<N> f, const uint32_t* __restrict__ a,
                  uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    F3<N> a0 = ld3<N>(a, 0, n, i), a1 = ld3<N>(a, 3, n, i);
    F3<N> ab = f3_mul(f, a0, a1);
    st3<N>(out, 3, n, i, f3_add(f, ab, ab));
    F3<N> t = f3_mul(f, f3_add(f, a0, a1), f3_add(f, a0, f3_mulv(f, a1)));
    st3<N>(out, 0, n, i, f3_sub(f, t, f3_add(f, ab, f3_mulv(f, ab))));
  }
}

// -- K13 --------------------------------------------------------------------------

// f = ((a0, a1, a2), (b0, b1, b2)) at planes 0-2 (a) and 3-5 (b).  For the
// pairs (x, y) = (b1, a0), (a2, b0), (b2, a1): x^2, y^2 and the cross term
// 2xy = (x + y)^2 - x^2 - y^2 from three squarings; t = 11 x^2 + y^2;
// a_k' = 3 t - 2 a_k, and b_k' = 3 c + 2 b_k with c the cross term, times
// 11 for (b2, a1) -> b0'.
template <int N>
__global__ void __launch_bounds__(kMntThreads)
    f6_cyc_sqr_kernel(Field<N> f, const uint32_t* __restrict__ a,
                      uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    const int xs[3] = {4, 2, 5}, ys[3] = {0, 3, 1};
    const int as[3] = {0, 1, 2}, bs[3] = {4, 5, 3};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Fe<N> x = ld<N>(a, xs[k], n, i), y = ld<N>(a, ys[k], n, i);
      Fe<N> sx = fmul(f, x, x), sy = fmul(f, y, y);
      Fe<N> xy = add(f, x, y);
      Fe<N> cross = sub(f, sub(f, fmul(f, xy, xy), sx), sy);
      Fe<N> t = add(f, mul_small(f, sx, kNR), sy);
      Fe<N> ak = ld<N>(a, as[k], n, i);
      st<N>(out, as[k], n, i,
            sub(f, add(f, add(f, t, t), t), add(f, ak, ak)));
      Fe<N> c = k == 2 ? mul_small(f, cross, kNR) : cross;
      Fe<N> bk = ld<N>(a, bs[k], n, i);
      st<N>(out, bs[k], n, i,
            add(f, add(f, add(f, c, c), c), add(f, bk, bk)));
    }
  }
}

// -- K14 --------------------------------------------------------------------------

// In: xyz = (X, Y, Z) [9, L, n], p = (xP, yP) [2, L, n].  mnt_dbl_formula:
// W = 3X^2 + 11 v^2 Z^2; line a0 = v^2 (2YZ^2 yP),
// b = WX - (2Y^2Z + v (WZ xP)); X' = 2YZ (W^2 - 8XY^2Z),
// Y' = W (12XY^2Z - W^2) - 8 (Y^2 Y^2) Z^2, Z' = 8 (Y^2 Y)(Z^2 Z), each
// square a product of the value with itself as in the formula.  Out:
// (a0, b, X', Y', Z') [15, L, n].
template <int N>
__global__ void __launch_bounds__(kMntThreads)
    mnt_miller_dbl_kernel(Field<N> f, const uint32_t* __restrict__ xyz,
                          const uint32_t* __restrict__ p,
                          uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    F3<N> Z = ld3<N>(xyz, 6, n, i);
    F3<N> Z2 = f3_mul(f, Z, Z);
    F3<N> Y = ld3<N>(xyz, 3, n, i);
    F3<N> YZ2 = f3_mul(f, Y, Z2);
    st3<N>(out, 0, n, i,
           f3_mulv2(f, f3_scal(f, f3_small(f, YZ2, 2), ld<N>(p, 1, n, i))));
    F3<N> Y2 = f3_mul(f, Y, Y);
    F3<N> Y2Z = f3_mul(f, Y2, Z);
    F3<N> YZ = f3_mul(f, Y, Z);
    F3<N> Y3 = f3_mul(f, Y2, Y);
    F3<N> Z3 = f3_mul(f, Z2, Z);
    st3<N>(out, 12, n, i, f3_small(f, f3_mul(f, Y3, Z3), 8));
    F3<N> Y4Z2 = f3_mul(f, f3_mul(f, Y2, Y2), Z2);
    F3<N> X = ld3<N>(xyz, 0, n, i);
    F3<N> W = f3_add(f, f3_small(f, f3_mul(f, X, X), 3),
                     f3_small(f, f3_mulv2(f, Z2), kNR));
    F3<N> WZxP = f3_scal(f, f3_mul(f, W, Z), ld<N>(p, 0, n, i));
    st3<N>(out, 3, n, i,
           f3_sub(f, f3_mul(f, W, X),
                  f3_add(f, f3_small(f, Y2Z, 2), f3_mulv(f, WZxP))));
    F3<N> W2 = f3_mul(f, W, W);
    F3<N> XY2Z = f3_mul(f, X, Y2Z);
    st3<N>(out, 6, n, i,
           f3_mul(f, f3_small(f, YZ, 2),
                  f3_sub(f, W2, f3_small(f, XY2Z, 8))));
    st3<N>(out, 9, n, i,
           f3_sub(f, f3_mul(f, W, f3_sub(f, f3_small(f, XY2Z, 12), W2)),
                  f3_small(f, Y4Z2, 8)));
  }
}

// In: xyz = (X, Y, Z) [9, L, n], q = (x2, y2) [6, L, n], p = (xP, yP).
// mnt_add_formula: th = y2 Z - Y, lm = x2 Z - X; line a0 = v^2 (lm yP),
// b = th x2 - (y2 lm + v (th xP)); C = th^2, D = lm^2, E = lm D, F = Z C,
// G = X D, H = F - 2G - E; X' = lm H, Y' = th (G - H) - E Y, Z' = Z E.
template <int N>
__global__ void __launch_bounds__(kMntThreads)
    mnt_miller_add_kernel(Field<N> f, const uint32_t* __restrict__ xyz,
                          const uint32_t* __restrict__ q,
                          const uint32_t* __restrict__ p,
                          uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    F3<N> Z = ld3<N>(xyz, 6, n, i);
    F3<N> x2 = ld3<N>(q, 0, n, i), y2 = ld3<N>(q, 3, n, i);
    F3<N> th = f3_sub(f, f3_mul(f, y2, Z), ld3<N>(xyz, 3, n, i));
    F3<N> lm = f3_sub(f, f3_mul(f, x2, Z), ld3<N>(xyz, 0, n, i));
    st3<N>(out, 0, n, i, f3_mulv2(f, f3_scal(f, lm, ld<N>(p, 1, n, i))));
    st3<N>(out, 3, n, i,
           f3_sub(f, f3_mul(f, th, x2),
                  f3_add(f, f3_mul(f, y2, lm),
                         f3_mulv(f, f3_scal(f, th, ld<N>(p, 0, n, i))))));
    F3<N> C = f3_mul(f, th, th), D = f3_mul(f, lm, lm);
    F3<N> E = f3_mul(f, lm, D);
    F3<N> Fv = f3_mul(f, Z, C);
    F3<N> G = f3_mul(f, ld3<N>(xyz, 0, n, i), D);
    F3<N> H = f3_sub(f, f3_sub(f, Fv, f3_small(f, G, 2)), E);
    st3<N>(out, 6, n, i, f3_mul(f, lm, H));
    st3<N>(out, 9, n, i,
           f3_sub(f, f3_mul(f, th, f3_sub(f, G, H)),
                  f3_mul(f, E, ld3<N>(xyz, 3, n, i))));
    st3<N>(out, 12, n, i, f3_mul(f, Z, E));
  }
}

inline unsigned mnt_grid(long long n) {
  long long blocks = (n + kMntThreads - 1) / kMntThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)blocks;
}

}  // namespace

extern "C" {

int k12_f6_mul(const void* a, const void* b, void* out, long long n,
               int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  f6_mul_kernel<kN><<<mnt_grid(n), kMntThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k12_f6_sqr(const void* a, void* out, long long n, int n_limbs,
               const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  f6_sqr_kernel<kN><<<mnt_grid(n), kMntThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k13_f6_cyc_sqr(const void* a, void* out, long long n, int n_limbs,
                   const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  f6_cyc_sqr_kernel<kN>
      <<<mnt_grid(n), kMntThreads, 0, (cudaStream_t)stream>>>(
          f, (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k14_mnt_miller_dbl(const void* xyz, const void* p, void* out, long long n,
                       int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  mnt_miller_dbl_kernel<kN>
      <<<mnt_grid(n), kMntThreads, 0, (cudaStream_t)stream>>>(
          f, (const uint32_t*)xyz, (const uint32_t*)p, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k14_mnt_miller_add(const void* xyz, const void* q, const void* p,
                       void* out, long long n, int n_limbs,
                       const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  mnt_miller_add_kernel<kN>
      <<<mnt_grid(n), kMntThreads, 0, (cudaStream_t)stream>>>(
          f, (const uint32_t*)xyz, (const uint32_t*)q, (const uint32_t*)p,
          (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
