// K8-K11: the extension-tower and Miller-step kernels of the BN128 and
// BLS12-381 pairings, for Hopper (sm_90a).
//
// K8  k8_f12_mul / k8_f12_sqr replace wasmsnark_tpu/ops/tower_pallas.py
//     _f12_mul_kernel (square=False / True): F12 = F6[w]/(w^2 - v)
//     Karatsuba product (3 F6 products of 6 F2 products each, 54 base
//     products) and square (2 F6 products).
// K9  k9_f12_cyc_sqr replaces tower_pallas.py _f12_cyc_sqr_kernel: the
//     Granger-Scott cyclotomic square (9 F2 squarings), the polynomial map
//     of wasmsnark_tpu/ops/towers.py gs_cyclotomic_square.
// K10 k10_miller_dbl / k10_miller_add replace tower_pallas.py
//     _miller_dbl_kernel / _miller_add_kernel: BN128's D-twist Miller steps
//     on homogeneous F2 coordinates, writing the sparse line (a0, b0, b1)
//     at P and the new point.
// K11 k11_miller_dbl_mtwist / k11_miller_add_mtwist replace tower_pallas.py
//     _miller_dbl_mtwist_kernel / _miller_add_mtwist_kernel: BLS12-381's
//     M-twist steps, the same point update with the line's w^0 term times
//     xi and its other two terms in the (v w, v^2 w) slots (b1, b2).
// Both Miller kernels compute exactly the products of the Pallas kernels:
// the representative of the new point is not unique, so the formulas are
// not free here.
//
// Towers: F2 = Fp[u]/(u^2 + 1), F6 = F2[v]/(v^3 - xi), F12 = F6[w]/(w^2 - v),
// with xi = xi0 + xi1 u a kernel argument (BN128: 9 + u; BLS12-381: 1 + u).
// The library is built per word count (fp.cuh, WORDS): N = 8 holds K8-K10
// for BN128, N = 12 holds K8, K9 and K11 for BLS12-381 (K10 and K11 return
// cudaErrorInvalidValue in the build that lacks them).  Every value is
// canonical (< q), so the results are bit-identical to the 16-bit-limb
// plain versions and the JAX package.
//
// Layout: an operand is one [k, L, n] tensor, component c of lane i at limb
// k sitting at p[(c * L + k) * n + i]: the JAX limb-plane layout, coalesced
// across threads, repacked to N 32-bit words in registers (fp.cuh).
//
// What bounds them on the H100: counted against the card's peaks, a K8
// product (54 Montgomery products of ~2N^2 IMADs, 36 planes of 2N 32-bit
// words per lane) needs about as much time for its bytes as for its
// operations.  But the verify and pairing batches launch K8 and K9 on
// 1,024-4,096 lanes, where one thread per lane (64-thread blocks) fills
// 16-64 of the 132 SMs and waits on its chain of 54 or 18 dependent base
// products.  So K8's product and K9 run a team of threads per lane
// (team.cuh): the lane's values in shared memory and its base products in
// one round, one a thread; K8's product keeps its one-thread design for more
// than K8_TEAM_MAX_LANES lanes at 8 words, where every SM is busy and one
// thread's chain is the cheaper, and for an xi other than its build's
// curve's.  K8's square and the Miller steps K10 and K11 run one thread per
// lane: one F12 operand is 12N words, so the square reads operand halves
// from device memory where a Karatsuba term needs them instead of keeping
// both operands in registers, and the F2 and F6 products are __noinline__
// functions, which keeps the build in seconds; their call boundaries cost
// spills that -Xptxas -v reports (the build log).  This source defines no
// FP_CIOS_ROLLED, so fp.cuh's and team.cuh's CIOS loops are unrolled here
// (the team kernels run 5-9 % slower rolled).

#include "team.cuh"

namespace {

constexpr int kTowerThreads = 64;

struct Xi {
  int c0, c1;
};

template <int N>
struct F2 {
  Fe<N> c0, c1;
};

template <int N>
struct F6 {
  F2<N> c0, c1, c2;
};

// -- F2 -------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ F2<N> f2_add(const Field<N>& f, const F2<N>& a,
                                        const F2<N>& b) {
  return {add(f, a.c0, b.c0), add(f, a.c1, b.c1)};
}

template <int N>
__device__ __forceinline__ F2<N> f2_sub(const Field<N>& f, const F2<N>& a,
                                        const F2<N>& b) {
  return {sub(f, a.c0, b.c0), sub(f, a.c1, b.c1)};
}

template <int N>
__device__ __forceinline__ F2<N> f2_neg(const Field<N>& f, const F2<N>& a) {
  return {sub(f, fe_zero<N>(), a.c0), sub(f, fe_zero<N>(), a.c1)};
}

template <int N>
__device__ __forceinline__ F2<N> f2_small(const Field<N>& f, const F2<N>& a,
                                          int k) {
  return {mul_small(f, a.c0, k), mul_small(f, a.c1, k)};
}

// (c0 a0 - c1 a1) + (c1 a0 + c0 a1) u
template <int N>
__device__ __forceinline__ F2<N> f2_mul_xi(const Field<N>& f, Xi xi,
                                           const F2<N>& a) {
  return {sub(f, mul_small(f, a.c0, xi.c0), mul_small(f, a.c1, xi.c1)),
          add(f, mul_small(f, a.c0, xi.c1), mul_small(f, a.c1, xi.c0))};
}

template <int N>
__device__ __forceinline__ F2<N> f2_mul_base(const Field<N>& f, const F2<N>& a,
                                             const Fe<N>& b) {
  return {mont_mul(f, a.c0, b), mont_mul(f, a.c1, b)};
}

// Karatsuba: 3 base products.
template <int N>
__device__ __noinline__ F2<N> f2_mul(const Field<N>& f, const F2<N>& a,
                                     const F2<N>& b) {
  Fe<N> m0 = mont_mul(f, a.c0, b.c0);
  Fe<N> m1 = mont_mul(f, a.c1, b.c1);
  Fe<N> t = mont_mul(f, add(f, a.c0, a.c1), add(f, b.c0, b.c1));
  return {sub(f, m0, m1), sub(f, sub(f, t, m0), m1)};
}

// Complex squaring: (a0 + a1)(a0 - a1) + 2 a0 a1 u, 2 base products.
template <int N>
__device__ __noinline__ F2<N> f2_sqr(const Field<N>& f, const F2<N>& a) {
  Fe<N> ab = mont_mul(f, a.c0, a.c1);
  return {mont_mul(f, add(f, a.c0, a.c1), sub(f, a.c0, a.c1)), add(f, ab, ab)};
}

// -- F6 -------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ F6<N> f6_add(const Field<N>& f, const F6<N>& a,
                                        const F6<N>& b) {
  return {f2_add(f, a.c0, b.c0), f2_add(f, a.c1, b.c1), f2_add(f, a.c2, b.c2)};
}

template <int N>
__device__ __forceinline__ F6<N> f6_sub(const Field<N>& f, const F6<N>& a,
                                        const F6<N>& b) {
  return {f2_sub(f, a.c0, b.c0), f2_sub(f, a.c1, b.c1), f2_sub(f, a.c2, b.c2)};
}

// v * a = (xi a2, a0, a1)
template <int N>
__device__ __forceinline__ F6<N> f6_mul_v(const Field<N>& f, Xi xi,
                                          const F6<N>& a) {
  return {f2_mul_xi(f, xi, a.c2), a.c0, a.c1};
}

// Karatsuba over the cubic extension: 6 F2 products (build_f3m.js).
template <int N>
__device__ __noinline__ F6<N> f6_mul(const Field<N>& f, Xi xi, const F6<N>& a,
                                     const F6<N>& b) {
  F2<N> v0 = f2_mul(f, a.c0, b.c0);
  F2<N> v1 = f2_mul(f, a.c1, b.c1);
  F2<N> v2 = f2_mul(f, a.c2, b.c2);
  F2<N> t12 = f2_mul(f, f2_add(f, a.c1, a.c2), f2_add(f, b.c1, b.c2));
  F2<N> c0 = f2_add(f, v0, f2_mul_xi(f, xi, f2_sub(f, f2_sub(f, t12, v1), v2)));
  F2<N> t01 = f2_mul(f, f2_add(f, a.c0, a.c1), f2_add(f, b.c0, b.c1));
  F2<N> c1 = f2_add(f, f2_sub(f, f2_sub(f, t01, v0), v1), f2_mul_xi(f, xi, v2));
  F2<N> t02 = f2_mul(f, f2_add(f, a.c0, a.c2), f2_add(f, b.c0, b.c2));
  F2<N> c2 = f2_add(f, f2_sub(f, f2_sub(f, t02, v0), v2), v1);
  return {c0, c1, c2};
}

// -- device memory ---------------------------------------------------------------

template <int N>
__device__ __forceinline__ F2<N> ld2(const uint32_t* __restrict__ p, int c,
                                     int64_t n, int64_t i) {
  return {ld<N>(p, c, n, i), ld<N>(p, c + 1, n, i)};
}

template <int N>
__device__ __forceinline__ void st2(uint32_t* __restrict__ p, int c, int64_t n,
                                    int64_t i, const F2<N>& a) {
  st<N>(p, c, n, i, a.c0);
  st<N>(p, c + 1, n, i, a.c1);
}

// F6 half h (0 or 1) of an F12 operand: components 6h .. 6h + 5
template <int N>
__device__ __forceinline__ F6<N> ld6(const uint32_t* __restrict__ p, int h,
                                     int64_t n, int64_t i) {
  return {ld2<N>(p, 6 * h, n, i), ld2<N>(p, 6 * h + 2, n, i),
          ld2<N>(p, 6 * h + 4, n, i)};
}

template <int N>
__device__ __forceinline__ void st6(uint32_t* __restrict__ p, int h, int64_t n,
                                    int64_t i, const F6<N>& a) {
  st2<N>(p, 6 * h, n, i, a.c0);
  st2<N>(p, 6 * h + 2, n, i, a.c1);
  st2<N>(p, 6 * h + 4, n, i, a.c2);
}

// -- K8 --------------------------------------------------------------------------

// The xi of the one curve each build's tower serves: BN128's 9 + u at 8
// words, BLS12-381's 1 + u at 12.  K8's team kernel is compiled for it,
// so that its small multiples are a few adds, or none.
constexpr Xi kBuildXi = WORDS == 8 ? Xi{9, 1} : Xi{1, 1};

// a * K for a compile-time K >= 1, a itself for K = 1
template <int K, int N>
__device__ __forceinline__ Fe<N> mul_const(const Field<N>& f,
                                           const Fe<N>& a) {
  if constexpr (K == 1) {
    return a;
  } else {
    return mul_small(f, a, K);
  }
}

// Component j of m y, y = u0 + u1 u given as own = u_j and other =
// u_(1-j): with use_xi, m = xi = X0 + X1 u known at compile time, X0 own -
// X1 other for j = 0 and + for j = 1; else m = 1, and other must be zero.
// Without a branch, and with no second result held beside the first.
template <int X0, int X1, int N>
__device__ __forceinline__ Fe<N> xi_part(const Field<N>& f, const Fe<N>& own,
                                         const Fe<N>& other, int j,
                                         bool use_xi) {
  const Fe<N> p = select(use_xi, mul_const<X0>(f, own), own);
  const Fe<N> q = mul_const<X1>(f, other);
  return add(f, p, select(j == 0, sub(f, fe_zero<N>(), q), q));
}

// Component j of coefficient k of the Karatsuba F6 product whose six F2
// products v0, v1, v2, t01, t12, t02 sit at slots r, r + 2, .., r + 10 of a
// team kernel (team.cuh kCoefSlots, the non-residue X0 + X1 u): m (D - E -
// F) first, its other component read as zero for k = 2 (m = 1), then
// A - B - C, one body for every k and j.
template <int N, int G, int X0, int X1>
__device__ __forceinline__ Fe<N> f6_coef(const Field<N>& f,
                                         const Slots<N, G>& s, int r, int k,
                                         int j, int g) {
  auto term = [&](int i, int c, bool keep) {
    const int d = kCoefSlots[k][i];
    return s.get_if(r + 2 * (d < 0 ? 0 : d) + c, keep && d >= 0, g);
  };
  const Fe<N> own = sub(f, sub(f, term(3, j, true), term(4, j, true)),
                        term(5, j, true));
  const Fe<N> other = sub(f, sub(f, term(3, 1 - j, k < 2),
                                 term(4, 1 - j, k < 2)),
                          term(5, 1 - j, k < 2));
  const Fe<N> y = xi_part<X0, X1>(f, own, other, j, k < 2);
  return add(f, sub(f, sub(f, term(0, j, true), term(1, j, true)),
                    term(2, j, true)), y);
}

// Table lines of the K8 product stage, two slots to an F2 value: the three
// base products m0 = x0 y0, m1 = x1 y1, (x0 + x1)(y0 + y1) of the Karatsuba
// F2 product of the values at slots x and y (F2_PRODS), or of the sums of
// those at x, x2 and at y, y2 (F2_PRODS_SUM), into o..o+2; and the 18 of
// the Karatsuba F6 product of the values at slots x.. and y.. (F2
// coefficient k at x + 2k), its F2 products in the order v0, v1, v2, t01,
// t12, t02 (F6_PRODS).
#define F2_PRODS(x, y, o)                                                    \
  {{x, kNoSlot, kNoSlot, kNoSlot}, {y, kNoSlot, kNoSlot, kNoSlot}, o},       \
  {{x + 1, kNoSlot, kNoSlot, kNoSlot}, {y + 1, kNoSlot, kNoSlot, kNoSlot},   \
   o + 1},                                                                   \
  {{x, x + 1, kNoSlot, kNoSlot}, {y, y + 1, kNoSlot, kNoSlot}, o + 2}
#define F2_PRODS_SUM(x, x2, y, y2, o)                                        \
  {{x, x2, kNoSlot, kNoSlot}, {y, y2, kNoSlot, kNoSlot}, o},                 \
  {{x + 1, x2 + 1, kNoSlot, kNoSlot}, {y + 1, y2 + 1, kNoSlot, kNoSlot},     \
   o + 1},                                                                   \
  {{x, x + 1, x2, x2 + 1}, {y, y + 1, y2, y2 + 1}, o + 2}
#define F6_PRODS(x, y, o)                                                    \
  F2_PRODS(x, y, o), F2_PRODS(x + 2, y + 2, o + 3),                          \
  F2_PRODS(x + 4, y + 4, o + 6), F2_PRODS_SUM(x, x + 2, y, y + 2, o + 9),    \
  F2_PRODS_SUM(x + 2, x + 4, y + 2, y + 4, o + 12),                          \
  F2_PRODS_SUM(x, x + 4, y, y + 4, o + 15)

// (a0 + a1 w)(b0 + b1 w) = (t0 + v t1) + (t2 - t0 - t1) w with t0 = a0 b0,
// t1 = a1 b1 and t2 = (a0 + a1)(b0 + b1), by a team of kK8Team threads per
// lane over kK8Lanes lanes a block: the 54 base products of the three F6
// products in one round.  Slots: a 0-11 and b 12-23 (component c of the
// operand at c), a0 + a1 at 24-29, b0 + b1 at 30-35, the base products of
// t0, t1 and t2 at 36, 54 and 72; once the products are done the 18 F2
// products at 0-35 (t_j's at 12 j), then t0, t1, t2 at 36, 42, 48.
// Stages: load 24 slots and their 12 sums, 54 products, 36 F2
// coefficients, 18 F6 coefficients, 12 outputs.  Two blocks fit an SM
// (the launch bounds hold a thread to 72 registers): from 2,048 lanes on
// one block's combines and loads then overlap another's products.  xi =
// X0 + X1 u is a template argument, kBuildXi.
constexpr int kK8Lanes = 8;
constexpr int kK8Team = 54;
constexpr int kK8Slots = 90;

__constant__ Prod kK8Prods[54] = {F6_PRODS(0, 12, 36), F6_PRODS(6, 18, 54),
                                  F6_PRODS(24, 30, 72)};

template <int N, int X0, int X1>
__global__ void __launch_bounds__(kK8Lanes * kK8Team, 2)
    f12_mul_kernel(Field<N> f, const uint32_t* __restrict__ a,
                   const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                   int64_t n) {
  constexpr int G = kK8Lanes;
  __shared__ uint32_t sm[kK8Slots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(12, base, n, [&](int c, int g) {   // a or b, and the sum
      const int k = c % 6, o = c < 6 ? 0 : 12;      // of its halves
      const Fe<N> x = ld<N>(c < 6 ? a : b, k, n, base + g);
      const Fe<N> y = ld<N>(c < 6 ? a : b, k + 6, n, base + g);
      s.put(o + k, g, x);
      s.put(o + k + 6, g, y);
      s.put(24 + c, g, add(f, x, y));
    });
    __syncthreads();
    prod_stage<N, G>(f, s, kK8Prods, 54, base, n);
    __syncthreads();
    team_for<G>(36, base, n, [&](int c, int g) {   // (m0 - m1, t - m0 - m1)
      const int r = 36 + 3 * (c / 2);
      const Fe<N> m0 = s.get(r, g);
      s.put(c, g, sub(f, select(c % 2 == 0, m0, sub(f, s.get(r + 2, g), m0)),
                      s.get(r + 1, g)));
    });
    __syncthreads();
    team_for<G>(18, base, n, [&](int c, int g) {   // t0, t1, t2
      s.put(36 + c, g, f6_coef<N, G, X0, X1>(f, s, 12 * (c / 6),
                                             (c % 6) / 2, c % 2, g));
    });
    __syncthreads();
    team_for<G>(6, base, n, [&](int c, int g) {    // t2 - t0 - t1
      st<N>(out, 6 + c, n, base + g,
            sub(f, sub(f, s.get(48 + c, g), s.get(36 + c, g)),
                s.get(42 + c, g)));
    });
    team_for<G>(6, base, n, [&](int c, int g) {    // t0 + v t1
      // v t1 = (xi t1_2, t1_0, t1_1): component c of t1_2 (slot 46 + c)
      // and its other one for c < 2, t1's component c - 2 for c >= 2
      const Fe<N> vt = xi_part<X0, X1>(
          f, s.get(c < 2 ? 46 + c : 40 + c, g),
          s.get_if(c < 2 ? 47 - c : 46, c < 2, g), c, c < 2);
      st<N>(out, c, n, base + g, add(f, s.get(36 + c, g), vt));
    }, warp_after(6, G));
    __syncthreads();
  }
}

// Above K8_TEAM_MAX_LANES lanes K8's product runs one thread a lane
// instead: at 8 words, with every SM busy, a team's combines and slot
// traffic cost more than one thread's chain (the crossover measured on the
// H100, PERF.md §6; chip_cios_unroll.py builds variants with other
// values).  At 12 words the team is the faster at every lane count.  An
// xi other than kBuildXi runs one thread a lane too.
#ifndef K8_TEAM_MAX_LANES
#define K8_TEAM_MAX_LANES (WORDS == 8 ? 16384 : 1LL << 62)
#endif

// The one-thread design: (a0 + a1 w)(b0 + b1 w) = (t0 + v t1) +
// ((a0 + a1)(b0 + b1) - t0 - t1) w, operand halves read again where a
// Karatsuba term needs them.
template <int N>
__global__ void __launch_bounds__(kTowerThreads)
    f12_mul_thread_kernel(Field<N> f, Xi xi, const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b,
                          uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    F6<N> t0 = f6_mul(f, xi, ld6<N>(a, 0, n, i), ld6<N>(b, 0, n, i));
    F6<N> t1 = f6_mul(f, xi, ld6<N>(a, 1, n, i), ld6<N>(b, 1, n, i));
    st6<N>(out, 0, n, i, f6_add(f, t0, f6_mul_v(f, xi, t1)));
    F6<N> s = f6_add(f, t0, t1);
    F6<N> t2 = f6_mul(f, xi, f6_add(f, ld6<N>(a, 0, n, i), ld6<N>(a, 1, n, i)),
                      f6_add(f, ld6<N>(b, 0, n, i), ld6<N>(b, 1, n, i)));
    st6<N>(out, 1, n, i, f6_sub(f, t2, s));
  }
}

// (a0 + a1 w)^2: ab = a0 a1, t = (a0 + a1)(a0 + v a1);
// c0 = t - ab - v ab, c1 = 2 ab
template <int N>
__global__ void __launch_bounds__(kTowerThreads)
    f12_sqr_kernel(Field<N> f, Xi xi, const uint32_t* __restrict__ a,
                   uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    F6<N> ab = f6_mul(f, xi, ld6<N>(a, 0, n, i), ld6<N>(a, 1, n, i));
    st6<N>(out, 1, n, i, f6_add(f, ab, ab));
    F6<N> a1 = ld6<N>(a, 1, n, i);
    F6<N> t = f6_mul(f, xi, f6_add(f, ld6<N>(a, 0, n, i), a1),
                     f6_add(f, ld6<N>(a, 0, n, i), f6_mul_v(f, xi, a1)));
    st6<N>(out, 0, n, i, f6_sub(f, f6_sub(f, t, ab), f6_mul_v(f, xi, ab)));
  }
}

// -- K9 --------------------------------------------------------------------------

// Components of f = ((a0, a1, a2), (b0, b1, b2)) at F2 slots 0, 2, 4 (a) and
// 6, 8, 10 (b).  For the pairs (x, y) = (b1, a0), (a2, b0), (b2, a1), k = 0,
// 1, 2: sx = x^2, sy = y^2 and the cross term c = (x + y)^2 - sx - sy from
// three F2 squarings, t = xi sx + sy; the pair's a side a_k' = 3 t - 2 a_k,
// its b side (b1', b2', b0') = 3 c + 2 b, c times xi for k = 2.
//
// By a team of kK9Team threads per lane over kK9Lanes lanes a block, in one
// round of base products.  An F2 square u^2 = ((u0 + u1)(u0 - u1), 2 u0 u1)
// takes two, and (x + y)^2 the two of ((x0 + y0), (x1 + y1)), whose
// difference is dx + dy.  So the load stage writes each F2 input's
// difference d = u0 - u1 to a slot of its own, and every base product is a
// product of slot sums (team.cuh Prod): 18 of them, 6 a pair.  Slots: the 12
// input components 0-11, the difference of the F2 value at 2j at 12 + j,
// pair k's products at 18 + 6k: x0 x1, (x0 + x1) dx, y0 y1, (y0 + y1) dy,
// (x0 + y0)(x1 + y1), (x0 + x1 + y0 + y1)(dx + dy).  Stages: load 12 slots
// and 6 differences, 18 products, 6 a-side and 6 b-side outputs.
constexpr int kK9Lanes = 8;
constexpr int kK9Team = 18;
constexpr int kK9Slots = 36;

#define K9_PAIR(x, y, o)                                                     \
  {{x, kNoSlot, kNoSlot, kNoSlot}, {x + 1, kNoSlot, kNoSlot, kNoSlot}, o},   \
  {{x, x + 1, kNoSlot, kNoSlot}, {12 + x / 2, kNoSlot, kNoSlot, kNoSlot},    \
   o + 1},                                                                   \
  {{y, kNoSlot, kNoSlot, kNoSlot}, {y + 1, kNoSlot, kNoSlot, kNoSlot},       \
   o + 2},                                                                   \
  {{y, y + 1, kNoSlot, kNoSlot}, {12 + y / 2, kNoSlot, kNoSlot, kNoSlot},    \
   o + 3},                                                                   \
  {{x, y, kNoSlot, kNoSlot}, {x + 1, y + 1, kNoSlot, kNoSlot}, o + 4},       \
  {{x, x + 1, y, y + 1}, {12 + x / 2, 12 + y / 2, kNoSlot, kNoSlot}, o + 5}

__constant__ Prod kK9Prods[18] = {K9_PAIR(8, 0, 18), K9_PAIR(4, 6, 24),
                                  K9_PAIR(10, 2, 30)};
// the components a_k (a side) and b_k (b side) of pair k
__constant__ int8_t kK9Side[2][3] = {{0, 2, 4}, {8, 10, 6}};

// Component c of xi (u0 + u1 u) as f2_mul_xi computes it, for either c
// without a branch.
template <int N>
__device__ __forceinline__ Fe<N> xi_coef(const Field<N>& f, Xi xi,
                                         const Fe<N>& u0, const Fe<N>& u1,
                                         int c) {
  const Fe<N> p = mul_small(f, u0, c ? xi.c1 : xi.c0);
  const Fe<N> q = mul_small(f, u1, c ? xi.c0 : xi.c1);
  return select(c == 0, sub(f, p, q), add(f, p, q));
}

template <int N>
__global__ void __launch_bounds__(kK9Lanes * kK9Team)
    f12_cyc_sqr_kernel(Field<N> f, Xi xi, const uint32_t* __restrict__ a,
                       uint32_t* __restrict__ out, int64_t n) {
  constexpr int G = kK9Lanes;
  __shared__ uint32_t sm[kK9Slots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(12, base, n, [&](int c, int g) {
      s.put(c, g, ld<N>(a, c, n, base + g));
    });
    team_for<G>(6, base, n, [&](int j, int g) {
      s.put(12 + j, g, sub(f, ld<N>(a, 2 * j, n, base + g),
                           ld<N>(a, 2 * j + 1, n, base + g)));
    }, 3 * kWarp);
    __syncthreads();
    prod_stage<N, G>(f, s, kK9Prods, 18, base, n);
    __syncthreads();
    team_for<G>(6, base, n, [&](int i, int g) {   // a_k' = 3 t - 2 a_k
      const int k = i / 2, c = i % 2, o = 18 + 6 * k;
      const Fe<N> p1x = s.get(o, g), p1y = s.get(o + 2, g);
      const Fe<N> sy = select(c == 0, s.get(o + 3, g), add(f, p1y, p1y));
      const Fe<N> t = add(f, xi_coef(f, xi, s.get(o + 1, g),
                                     add(f, p1x, p1x), c), sy);
      const Fe<N> ak = s.get(kK9Side[0][k] + c, g);
      st<N>(out, kK9Side[0][k] + c, n, base + g,
            sub(f, add(f, add(f, t, t), t), add(f, ak, ak)));
    });
    team_for<G>(6, base, n, [&](int i, int g) {   // b' = 3 c + 2 b
      const int k = i / 2, c = i % 2, o = 18 + 6 * k;
      const Fe<N> p1x = s.get(o, g), p1y = s.get(o + 2, g);
      const Fe<N> p1s = s.get(o + 4, g);
      const Fe<N> cr0 = sub(f, sub(f, s.get(o + 5, g), s.get(o + 1, g)),
                            s.get(o + 3, g));
      const Fe<N> cr1 = sub(f, sub(f, add(f, p1s, p1s), add(f, p1x, p1x)),
                            add(f, p1y, p1y));
      const Fe<N> cr = select(k == 2, xi_coef(f, xi, cr0, cr1, c),
                              select(c == 0, cr0, cr1));
      const Fe<N> bk = s.get(kK9Side[1][k] + c, g);
      st<N>(out, kK9Side[1][k] + c, n, base + g,
            add(f, add(f, add(f, cr, cr), cr), add(f, bk, bk)));
    }, 2 * kWarp);
    __syncthreads();
  }
}

// -- K10 -------------------------------------------------------------------------

// Line slots of the two twists: the D twist (BN128, K10) writes the line
// (a0, b0, b1) = (c_y yP, c_x xP, c_0); the M twist (BLS12-381, K11) writes
// (a0, b1, b2) = (xi c_y yP, c_0, c_x xP).
template <bool kMTwist>
struct LineSlots {
  static constexpr int kX = kMTwist ? 4 : 2;   // c_x xP
  static constexpr int k0 = kMTwist ? 2 : 4;   // c_0
};

// In: xyz = (X, Y, Z) [6, L, n], p = (xP, yP) [2, L, n].
// Line: c_y = 2YZ^2, c_x = -3X^2Z, c_0 = 3X^3 - 2Y^2Z; then
// X' = 2YZ (9X^4 - 8XY^2Z), Y' = 36X^3Y^2Z - 27X^4X^2 - 8(Y^2Z)^2,
// Z' = 8 Y^3 Z^3 at planes 6..11 of out [12, L, n].
template <int N, bool kMTwist>
__global__ void __launch_bounds__(kTowerThreads)
    miller_dbl_kernel(Field<N> f, Xi xi, const uint32_t* __restrict__ xyz,
                      const uint32_t* __restrict__ p,
                      uint32_t* __restrict__ out, int64_t n) {
  using S = LineSlots<kMTwist>;
  LANE_LOOP(i, n) {
    F2<N> X = ld2<N>(xyz, 0, n, i), Y = ld2<N>(xyz, 2, n, i),
          Z = ld2<N>(xyz, 4, n, i);
    F2<N> X2 = f2_sqr(f, X), Y2 = f2_sqr(f, Y), Z2 = f2_sqr(f, Z);
    F2<N> Y2Z = f2_mul(f, Y2, Z);
    F2<N> YZ2 = f2_mul(f, Y, Z2);
    F2<N> c_y = f2_add(f, YZ2, YZ2);
    if (kMTwist) c_y = f2_mul_xi(f, xi, c_y);
    st2<N>(out, 0, n, i, f2_mul_base(f, c_y, ld<N>(p, 1, n, i)));
    st2<N>(out, S::kX, n, i,
           f2_mul_base(f, f2_neg(f, f2_small(f, f2_mul(f, X2, Z), 3)),
                       ld<N>(p, 0, n, i)));
    F2<N> X3c = f2_mul(f, X2, X);
    st2<N>(out, S::k0, n, i,
           f2_sub(f, f2_small(f, X3c, 3), f2_small(f, Y2Z, 2)));
    F2<N> X4 = f2_sqr(f, X2);
    F2<N> t1 = f2_sub(f, f2_small(f, X4, 9), f2_small(f, f2_mul(f, X, Y2Z), 8));
    st2<N>(out, 6, n, i, f2_mul(f, f2_small(f, f2_mul(f, Y, Z), 2), t1));
    F2<N> Yn = f2_sub(f,
                      f2_sub(f, f2_small(f, f2_mul(f, X3c, Y2Z), 36),
                             f2_small(f, f2_mul(f, X4, X2), 27)),
                      f2_small(f, f2_sqr(f, Y2Z), 8));
    st2<N>(out, 8, n, i, Yn);
    st2<N>(out, 10, n, i,
           f2_small(f, f2_mul(f, f2_mul(f, Y2, Y), f2_mul(f, Z2, Z)), 8));
  }
}

// In: xyz = (X, Y, Z) [6, L, n], q = (x2, y2) [4, L, n], p = (xP, yP).
// th = y2 Z - Y, lm = x2 Z - X; line c_y = lm, c_x = -th,
// c_0 = th x2 - lm y2; C = th^2, D = lm^2, E = lm D, F = Z C, G = X D,
// H = F - 2G - E; X' = lm H, Y' = th (G - H) - E Y, Z' = Z E.
template <int N, bool kMTwist>
__global__ void __launch_bounds__(kTowerThreads)
    miller_add_kernel(Field<N> f, Xi xi, const uint32_t* __restrict__ xyz,
                      const uint32_t* __restrict__ q,
                      const uint32_t* __restrict__ p,
                      uint32_t* __restrict__ out, int64_t n) {
  using S = LineSlots<kMTwist>;
  LANE_LOOP(i, n) {
    F2<N> X = ld2<N>(xyz, 0, n, i), Y = ld2<N>(xyz, 2, n, i),
          Z = ld2<N>(xyz, 4, n, i);
    F2<N> x2 = ld2<N>(q, 0, n, i), y2 = ld2<N>(q, 2, n, i);
    F2<N> th = f2_sub(f, f2_mul(f, y2, Z), Y);
    F2<N> lm = f2_sub(f, f2_mul(f, x2, Z), X);
    st2<N>(out, 0, n, i,
           f2_mul_base(f, kMTwist ? f2_mul_xi(f, xi, lm) : lm,
                       ld<N>(p, 1, n, i)));
    st2<N>(out, S::kX, n, i, f2_mul_base(f, f2_neg(f, th), ld<N>(p, 0, n, i)));
    st2<N>(out, S::k0, n, i, f2_sub(f, f2_mul(f, th, x2), f2_mul(f, lm, y2)));
    F2<N> C = f2_sqr(f, th), D = f2_sqr(f, lm);
    F2<N> E = f2_mul(f, lm, D);
    F2<N> Fv = f2_mul(f, Z, C), G = f2_mul(f, X, D);
    F2<N> H = f2_sub(f, f2_sub(f, Fv, f2_add(f, G, G)), E);
    st2<N>(out, 6, n, i, f2_mul(f, lm, H));
    st2<N>(out, 8, n, i,
           f2_sub(f, f2_mul(f, th, f2_sub(f, G, H)), f2_mul(f, E, Y)));
    st2<N>(out, 10, n, i, f2_mul(f, Z, E));
  }
}

inline unsigned tower_grid(long long n) {
  long long blocks = (n + kTowerThreads - 1) / kTowerThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)blocks;
}

// Host launchers of the Miller kernels: K10 (D twist) exists in the N = 8
// build (BN128), K11 (M twist) in the N = 12 build (BLS12-381); each entry
// point returns cudaErrorInvalidValue in the other.
template <bool kMTwist>
int miller_dbl(const void* xyz, const void* p, void* out, long long n,
               Xi xi, int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  miller_dbl_kernel<kN, kMTwist>
      <<<tower_grid(n), kTowerThreads, 0, (cudaStream_t)stream>>>(
          f, xi, (const uint32_t*)xyz, (const uint32_t*)p, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

template <bool kMTwist>
int miller_add(const void* xyz, const void* q, const void* p, void* out,
               long long n, Xi xi, int n_limbs, const void* consts,
               void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  miller_add_kernel<kN, kMTwist>
      <<<tower_grid(n), kTowerThreads, 0, (cudaStream_t)stream>>>(
          f, xi, (const uint32_t*)xyz, (const uint32_t*)q, (const uint32_t*)p,
          (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int k8_f12_mul(const void* a, const void* b, void* out, long long n,
               long long xi0, long long xi1, int n_limbs, const void* consts,
               void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  const Xi xi{(int)xi0, (int)xi1};
  if (n <= (K8_TEAM_MAX_LANES) && xi.c0 == kBuildXi.c0 &&
      xi.c1 == kBuildXi.c1) {
    f12_mul_kernel<kN, kBuildXi.c0, kBuildXi.c1>
        <<<team_grid(n, kK8Lanes), kK8Lanes * kK8Team, 0,
           (cudaStream_t)stream>>>(
            f, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  } else {
    f12_mul_thread_kernel<kN><<<tower_grid(n), kTowerThreads, 0,
                                (cudaStream_t)stream>>>(
        f, xi, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

int k8_f12_sqr(const void* a, void* out, long long n, long long xi0,
               long long xi1, int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  f12_sqr_kernel<kN><<<tower_grid(n), kTowerThreads, 0, (cudaStream_t)stream>>>(
      f, Xi{(int)xi0, (int)xi1}, (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k9_f12_cyc_sqr(const void* a, void* out, long long n, long long xi0,
                   long long xi1, int n_limbs, const void* consts,
                   void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  f12_cyc_sqr_kernel<kN>
      <<<team_grid(n, kK9Lanes), kK9Lanes * kK9Team, 0,
         (cudaStream_t)stream>>>(
          f, Xi{(int)xi0, (int)xi1}, (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k10_miller_dbl(const void* xyz, const void* p, void* out, long long n,
                   int n_limbs, const void* consts, void* stream) {
#if WORDS == 8
  return miller_dbl<false>(xyz, p, out, n, Xi{0, 0}, n_limbs, consts, stream);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

int k10_miller_add(const void* xyz, const void* q, const void* p, void* out,
                   long long n, int n_limbs, const void* consts,
                   void* stream) {
#if WORDS == 8
  return miller_add<false>(xyz, q, p, out, n, Xi{0, 0}, n_limbs, consts,
                           stream);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

int k11_miller_dbl_mtwist(const void* xyz, const void* p, void* out,
                          long long n, long long xi0, long long xi1,
                          int n_limbs, const void* consts, void* stream) {
#if WORDS == 12
  return miller_dbl<true>(xyz, p, out, n, Xi{(int)xi0, (int)xi1}, n_limbs,
                          consts, stream);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

int k11_miller_add_mtwist(const void* xyz, const void* q, const void* p,
                          void* out, long long n, long long xi0,
                          long long xi1, int n_limbs, const void* consts,
                          void* stream) {
#if WORDS == 12
  return miller_add<true>(xyz, q, p, out, n, Xi{(int)xi0, (int)xi1}, n_limbs,
                          consts, stream);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

// Threads a block of the kernels above, in the order of their entry points
// (k8_f12_mul's team kernel, k8_f12_sqr, k9_f12_cyc_sqr, the Miller
// doubling, the Miller add): the occupancy report of chip_cios_unroll.py.
void tower_block_threads(int* threads) {
  const int t[5] = {kK8Lanes * kK8Team, kTowerThreads, kK9Lanes * kK9Team,
                    kTowerThreads, kTowerThreads};
  for (int k = 0; k < 5; ++k) threads[k] = t[k];
}

}  // extern "C"
