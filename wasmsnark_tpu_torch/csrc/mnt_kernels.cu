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
// (the JAX package adds 10 times; the canonical value is the same).  The
// library is built only at N = 24 words (MNT6753's 753-bit Fq, 48 16-bit
// limbs): the CIOS bound of fp.cuh, q < 2^(32N - 2) = 2^766, holds.  Every
// value is canonical (< q), so the results are bit-identical to the
// 16-bit-limb plain versions and the JAX package.
//
// Layout: an operand is one [k, L, n] tensor, component c of lane i at limb
// j sitting at p[(c * L + j) * n + i] (fp.cuh ld/st): an F6 element is its 6
// planes (a0, a1, a2, b0, b1, b2), a Miller point (X, Y, Z) 9 planes, an
// affine twist point (x2, y2) 6, the G1 point (xP, yP) 2; the Miller steps
// write 15 planes (a0, b, X', Y', Z').
//
// What bounds them on the H100: counted against the card's peaks, K14's
// steps (84-108 Montgomery products of ~2N^2 = 1,152 wide multiply-adds)
// need more time for their operations than for their 26-32 planes of 2N
// words per lane, and K12's product about as much for both.  But the
// MNT6753 paths launch them on 255-512 lanes, where one thread per lane
// fills 4-8 of the 132 SMs and the time is one thread's serial chain of
// products (18 in K12's product, 108 in a one-thread doubling): the latency
// of a thread bounds them, not the card's throughput.  So the product and
// the doubling run a team of threads per lane (team.cuh): the lane's values
// in shared memory, one base product per thread per round, which shortens
// the chain to one round of products (K12) and four (K14) plus their
// combines.  K12's square, K13 and K14's add still run one thread per
// lane: an F6 operand is 6N = 144 words and a Miller point 9N = 216, more
// than the 255 registers of a thread, so their base product is one
// __noinline__ copy of the CIOS body, the F3 product is __noinline__ too,
// and they read their inputs from device memory where a formula needs
// them again instead of keeping them live; the call boundaries cost spills
// that -Xptxas -v reports (the build log).

// Both CIOS products here, fmul's and the team kernels' (team.cuh
// mont_mul_nc), keep their outer loop rolled: on the H100 that builds this
// library ~11 s faster, and the team kernels run faster rolled at every
// lane count; the one-thread kernels (K12's square, K13, K14's add) would
// run 15-24 % faster unrolled at the paths' 256 lanes (chip_cios_unroll.py,
// PERF.md §6), which is left to their redesign.
#define FP_CIOS_ROLLED
#include "team.cuh"

namespace {

constexpr int kMntThreads = 64;
constexpr int kWarp = 32;
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

// Coefficient k of the Karatsuba F3 product whose base products v0, v1,
// v2, t01, t12, t02 sit at slots r..r+5 of a team kernel, as f3_mul
// combines them: c_k = (A - B - C) + m (D - E - F), with
//   k = 0: v0 - 0 - 0 + 11 (t12 - v1 - v2),
//   k = 1: t01 - v0 - v1 + 11 (v2 - 0 - 0),
//   k = 2: t02 - v0 - v2 + (v1 - 0 - 0):
// one straight-line body for every k, so that the items of a warp, which
// take different k, do not diverge (slot offsets from r, -1 for zero).
__constant__ int8_t kCoefSlots[3][6] = {
    {0, -1, -1, 4, 1, 2}, {3, 0, 1, 2, -1, -1}, {5, 0, 2, 1, -1, -1}};

template <int N, int G>
__device__ __forceinline__ Fe<N> f3_coef(const Field<N>& f,
                                         const Slots<N, G>& s, int r, int k,
                                         int g) {
  auto term = [&](int j) {
    const int d = kCoefSlots[k][j];
    Fe<N> v = s.get(r + (d < 0 ? 0 : d), g);
    const uint32_t keep = d < 0 ? 0u : ~0u;
#pragma unroll
    for (int w = 0; w < N; ++w) v.w[w] &= keep;
    return v;
  };
  const Fe<N> x = sub(f, sub(f, term(0), term(1)), term(2));
  const Fe<N> y = sub(f, sub(f, term(3), term(4)), term(5));
  return add(f, x, select(k == 2, y, mul_small(f, y, kNR)));
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

// (a0 + a1 w)(b0 + b1 w) = (m0 + v m1) + ((a0 + a1)(b0 + b1) - (m0 + m1)) w,
// by a team of kK12Team threads per lane over kK12Lanes lanes a block.
// Slots: a0 0-2, a1 3-5, b0 6-8, b1 9-11; the 18 base products of m0, m1
// and t = (a0 + a1)(b0 + b1) at 12-17, 18-23, 24-29; m0, m1, t at 0-8
// once the products are done.  Stages: load 12 slots, 18 products, 9 F3
// coefficients, 6 outputs.
constexpr int kK12Lanes = 8;
constexpr int kK12Team = 18;
constexpr int kK12Slots = 30;

__constant__ Prod kK12Prods[18] = {F3_PRODS(0, 6, 12), F3_PRODS(3, 9, 18),
                                   F3_PRODS_SUM(0, 3, 6, 9, 24)};

template <int N>
__global__ void __launch_bounds__(kK12Lanes * kK12Team)
    f6_mul_kernel(Field<N> f, const uint32_t* __restrict__ a,
                  const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                  int64_t n) {
  constexpr int G = kK12Lanes;
  __shared__ uint32_t sm[kK12Slots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(12, base, n, [&](int c, int g) {
      s.put(c, g, ld<N>(c < 6 ? a : b, c % 6, n, base + g));
    });
    __syncthreads();
    prod_stage<N, G>(f, s, kK12Prods, 18, base, n);
    __syncthreads();
    team_for<G>(9, base, n, [&](int c, int g) {   // m0, m1, t
      s.put(c, g, f3_coef<N, G>(f, s, 12 + 6 * (c / 3), c % 3, g));
    });
    __syncthreads();
    team_for<G>(5, base, n, [&](int c, int g) {   // m0 + v m1, t - m0 - m1
      const int k = (c + 1) % 3;
      const Fe<N> r = c < 2 ? add(f, s.get(k, g), s.get(2 + k, g))
                            : sub(f, sub(f, s.get(6 + k, g), s.get(k, g)),
                                  s.get(3 + k, g));
      st<N>(out, c + 1, n, base + g, r);
    });
    team_for<G>(1, base, n, [&](int, int g) {     // its c0 = m0 + 11 m1_2
      st<N>(out, 0, n, base + g,
            add(f, s.get(0, g), mul_small(f, s.get(5, g), kNR)));
    }, 2 * kWarp);
    __syncthreads();
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
//
// By a team of kDblTeam threads per lane over kDblLanes lanes a block, in
// four levels of F3 products, each followed by one combine stage:
//   P1  ZZ, YY, YZ, XX              -> Z2, Y2, U = 2YZ, W
//   P2  Y Z2, Y2 Z, WZ, WX, WW      -> YZ2, Y2Z, WZ, WX, W2
//   P3  Y2Z YZ2, Y2Z Y2Z, X Y2Z, WZ xP, YZ2 yP
//                                   -> Z' = 8 Y3Z3, Y4Z2, a0, b, V, S
//   P4  U V, W S                    -> X' = UV, Y' = WS - 8 Y4Z2
// with V = W2 - 8 XY2Z and S = 12 XY2Z - W2.  Y3 Z3 = (Y2Z)(YZ2) and
// Y4 Z2 = (Y2Z)^2 are the formula's values by 90 base products instead of
// 108, and a combine item that needs a coefficient of a product that is
// not in a slot (W's Z2, V's and S's XY2Z) combines it itself.  Slots: X
// 0, Y 3, Z 6, xP 9, yP 10, Z2 11, Y2 14, U 17, W 20, YZ2 23, Y2Z 26, WZ
// 29, WX 32, W2 35, Y4Z2 38, V 41, S 44, and the raw base products of the
// level in flight from kRaw (30 slots).
constexpr int kDblLanes = 4;
constexpr int kDblTeam = 30;
constexpr int kRaw = 47;
constexpr int kDblSlots = kRaw + 30;

__constant__ Prod kDblProds[90] = {
    // P1
    F3_PRODS(6, 6, kRaw), F3_PRODS(3, 3, kRaw + 6), F3_PRODS(3, 6, kRaw + 12),
    F3_PRODS(0, 0, kRaw + 18),
    // P2
    F3_PRODS(3, 11, kRaw), F3_PRODS(14, 6, kRaw + 6),
    F3_PRODS(20, 6, kRaw + 12), F3_PRODS(20, 0, kRaw + 18),
    F3_PRODS(20, 20, kRaw + 24),
    // P3
    F3_PRODS(26, 23, kRaw), F3_PRODS(26, 26, kRaw + 6),
    F3_PRODS(0, 26, kRaw + 12), F3_SCAL(29, 9, kRaw + 18),
    F3_SCAL(23, 10, kRaw + 21),
    // P4
    F3_PRODS(17, 41, kRaw), F3_PRODS(20, 44, kRaw + 6)};
__constant__ int kDblLevel[5] = {0, 24, 54, 78, 90};   // P1-P4 in kDblProds

template <int N, int G>
__device__ __forceinline__ void dbl_combine(const Field<N>& f,
                                            const Slots<N, G>& s, int level,
                                            uint32_t* __restrict__ out,
                                            int64_t base, int64_t n) {
  switch (level) {
    case 0:
      team_for<G>(9, base, n, [&](int c, int g) {   // Z2, Y2, U = 2YZ
        const Fe<N> v = f3_coef<N, G>(f, s, kRaw + 6 * (c / 3), c % 3, g);
        s.put(11 + c, g, add(f, v, select(c < 6, fe_zero<N>(), v)));
      });
      team_for<G>(3, base, n, [&](int k, int g) {   // W = 3X^2 + 11 v^2 Z2
        const Fe<N> z = f3_coef<N, G>(f, s, kRaw, (k + 1) % 3, g);
        const Fe<N> t = mul_small(f, select(k == 2, z, mul_small(f, z, kNR)),
                                  kNR);
        const Fe<N> x2 = f3_coef<N, G>(f, s, kRaw + 18, k, g);
        s.put(20 + k, g, add(f, mul_small(f, x2, 3), t));
      }, 2 * kWarp);
      break;
    case 1:
      team_for<G>(15, base, n, [&](int c, int g) {
        s.put(23 + c, g, f3_coef<N, G>(f, s, kRaw + 6 * (c / 3), c % 3, g));
      });
      break;
    case 2:
      team_for<G>(12, base, n, [&](int c, int g) {
        // a coefficient x of Y3Z3, Y4Z2 or XY2Z, then Z' = 8x, Y4Z2 = x,
        // V = W2 - 8x, S = 12x - W2
        const int k = c % 3, i = c / 3;
        const Fe<N> x = f3_coef<N, G>(f, s, kRaw + 6 * (i < 2 ? i : 2), k, g);
        const Fe<N> x4 = mul_small(f, x, 4), x8 = add(f, x4, x4);
        const Fe<N> m = select(i == 1, x, select(i == 3, add(f, x8, x4), x8));
        const Fe<N> w2 = s.get(35 + k, g);
        const Fe<N> r = sub(f, select(i == 2, w2, m),
                            select(i == 2, m, select(i == 3, w2,
                                                     fe_zero<N>())));
        if (i == 0)
          st<N>(out, 12 + k, n, base + g, r);
        else
          s.put(38 + 3 * (i - 1) + k, g, r);
      });
      team_for<G>(3, base, n, [&](int k, int g) {   // a0 = v^2 (2 YZ2 yP)
        const Fe<N> t = s.get(kRaw + 21 + (k + 1) % 3, g);
        const Fe<N> t2 = add(f, t, t);
        st<N>(out, k, n, base + g,
              select(k == 2, t2, mul_small(f, t2, kNR)));
      }, 2 * kWarp);
      team_for<G>(3, base, n, [&](int k, int g) {   // b = WX - (2Y2Z + v WZxP)
        const Fe<N> t = s.get(kRaw + 18 + (k + 2) % 3, g);
        const Fe<N> vt = select(k == 0, mul_small(f, t, kNR), t);
        const Fe<N> y = s.get(26 + k, g);
        st<N>(out, 3 + k, n, base + g,
              sub(f, s.get(32 + k, g), add(f, add(f, y, y), vt)));
      }, 3 * kWarp);
      break;
    default:
      team_for<G>(6, base, n, [&](int c, int g) {   // X' = UV, Y' = WS - 8Y4Z2
        const int k = c % 3;
        Fe<N> r = f3_coef<N, G>(f, s, kRaw + 6 * (c / 3), k, g);
        if (c >= 3) r = sub(f, r, mul_small(f, s.get(38 + k, g), 8));
        st<N>(out, 6 + c, n, base + g, r);
      });
  }
}

template <int N>
__global__ void __launch_bounds__(kDblLanes * kDblTeam)
    mnt_miller_dbl_kernel(Field<N> f, const uint32_t* __restrict__ xyz,
                          const uint32_t* __restrict__ p,
                          uint32_t* __restrict__ out, int64_t n) {
  constexpr int G = kDblLanes;
  __shared__ uint32_t sm[kDblSlots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(11, base, n, [&](int c, int g) {
      s.put(c, g, c < 9 ? ld<N>(xyz, c, n, base + g)
                        : ld<N>(p, c - 9, n, base + g));
    });
    __syncthreads();
#pragma unroll 1
    for (int level = 0; level < 4; ++level) {
      prod_stage<N, G>(f, s, kDblProds + kDblLevel[level],
                       kDblLevel[level + 1] - kDblLevel[level], base, n);
      __syncthreads();
      dbl_combine<N, G>(f, s, level, out, base, n);
      __syncthreads();
    }
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
  f6_mul_kernel<kN><<<team_grid(n, kK12Lanes), kK12Lanes * kK12Team, 0,
                      (cudaStream_t)stream>>>(
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
      <<<team_grid(n, kDblLanes), kDblLanes * kDblTeam, 0,
         (cudaStream_t)stream>>>(
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

// Threads a block of the kernels above, in the order of their entry points
// (k12_f6_mul, k12_f6_sqr, k13_f6_cyc_sqr, k14_mnt_miller_dbl,
// k14_mnt_miller_add): the occupancy report of chip_cios_unroll.py.
void mnt_block_threads(int* threads) {
  const int t[5] = {kK12Lanes * kK12Team, kMntThreads, kMntThreads,
                    kDblLanes * kDblTeam, kMntThreads};
  for (int k = 0; k < 5; ++k) threads[k] = t[k];
}

}  // extern "C"
