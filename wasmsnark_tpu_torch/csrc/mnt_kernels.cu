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
// steps (84-90 Montgomery products of ~2N^2 = 1,152 wide multiply-adds) need
// more time for their operations than for their 26-32 planes of 2N words per
// lane, and K12's product about as much for both.  But the MNT6753 paths
// launch them on 255-512 lanes, where one thread per lane fills 4-8 of the
// 132 SMs and the time is one thread's serial chain of products (18 in K12's
// product, 12 in its square, 84-108 in a Miller step): the latency of a
// thread bounds them, not the card's throughput.  So every kernel here
// runs a team of threads per lane (team.cuh): the lane's values in shared
// memory, one base product per thread per round, which shortens the chain
// to one round of products (K12, K13) and four (each K14 step) plus their
// combines.

// The team kernels' CIOS product (fp.cuh mont_mul_nc) keeps its outer loop
// rolled: on the H100 that builds this library ~11 s faster, and the team
// kernels run faster rolled at every lane count (chip_cios_unroll.py,
// PERF.md §6).
#define FP_CIOS_ROLLED
#include "team.cuh"

namespace {

constexpr int kNR = 11;            // F3 non-residue, G1's a, G2's a2 / v^2

// -- F3 --------------------------------------------------------------------------

// Coefficient k of the Karatsuba F3 product whose base products v0, v1,
// v2, t01, t12, t02 sit at slots r..r+5 of a team kernel (team.cuh
// kCoefSlots, the non-residue 11).
template <int N, int G>
__device__ __forceinline__ Fe<N> f3_coef(const Field<N>& f,
                                         const Slots<N, G>& s, int r, int k,
                                         int g) {
  auto term = [&](int j) {
    const int d = kCoefSlots[k][j];
    return s.get_if(r + (d < 0 ? 0 : d), d >= 0, g);
  };
  const Fe<N> x = sub(f, sub(f, term(0), term(1)), term(2));
  const Fe<N> y = sub(f, sub(f, term(3), term(4)), term(5));
  return add(f, x, select(k == 2, y, mul_small(f, y, kNR)));
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

// (a0 + a1 w)^2 = (t - ab - v ab) + 2 ab w with ab = a0 a1 and
// t = (a0 + a1)(a0 + v a1) (towers.py F2Device.square over F3), by a team
// of kSqrTeam threads per lane over kSqrLanes lanes a block.  Slots: a0
// 0-2, a1 3-5, v a1 = (11 a1_2, a1_0, a1_1) 6-8; the 12 base products of
// ab and t at 9-14 and 15-20; ab and t at 0-5 once the products are done.
// Stages: load 9 slots, 12 products, 6 F3 coefficients, 6 outputs.
constexpr int kSqrLanes = 8;
constexpr int kSqrTeam = 12;
constexpr int kSqrSlots = 21;

__constant__ Prod kSqrProds[12] = {F3_PRODS(0, 3, 9),
                                   F3_PRODS_SUM(0, 3, 0, 6, 15)};

template <int N>
__global__ void __launch_bounds__(kSqrLanes * kSqrTeam)
    f6_sqr_kernel(Field<N> f, const uint32_t* __restrict__ a,
                  uint32_t* __restrict__ out, int64_t n) {
  constexpr int G = kSqrLanes;
  __shared__ uint32_t sm[kSqrSlots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(9, base, n, [&](int c, int g) {   // a0, a1, v a1
      const Fe<N> v = ld<N>(a, c < 6 ? c : 3 + (c + 2) % 3, n, base + g);
      s.put(c, g, select(c == 6, mul_small(f, v, kNR), v));
    });
    __syncthreads();
    prod_stage<N, G>(f, s, kSqrProds, 12, base, n);
    __syncthreads();
    team_for<G>(6, base, n, [&](int c, int g) {   // ab, t
      s.put(c, g, f3_coef<N, G>(f, s, 9 + 6 * (c / 3), c % 3, g));
    });
    __syncthreads();
    team_for<G>(3, base, n, [&](int k, int g) {   // c1 = 2 ab
      const Fe<N> ab = s.get(k, g);
      st<N>(out, 3 + k, n, base + g, add(f, ab, ab));
    });
    team_for<G>(3, base, n, [&](int k, int g) {   // c0 = t - ab - v ab
      const Fe<N> w = s.get((k + 2) % 3, g);
      const Fe<N> vab = select(k == 0, mul_small(f, w, kNR), w);
      st<N>(out, k, n, base + g,
            sub(f, sub(f, s.get(3 + k, g), s.get(k, g)), vab));
    }, warp_after(3, G));
    __syncthreads();
  }
}

// -- K13 --------------------------------------------------------------------------

// f = ((a0, a1, a2), (b0, b1, b2)) at planes 0-2 (a) and 3-5 (b).  For the
// pairs (x, y) = (b1, a0), (a2, b0), (b2, a1): x^2, y^2 and the cross term
// 2xy = (x + y)^2 - x^2 - y^2 from three squarings; t = 11 x^2 + y^2;
// a_k' = 3 t - 2 a_k, and b_k' = 3 c + 2 b_k with c the cross term, times
// 11 for (b2, a1) -> b0'.
//
// By a team of kCycTeam threads per lane over kCycLanes lanes a block.
// Slots: a0, a1, a2, b0, b1, b2 at 0-5; pair k's x^2, y^2, (x + y)^2 at
// 6 + 3k .. 8 + 3k.  Stages: load 6 slots, 9 squarings, 6 outputs (the
// three a_k' and, on warps of their own, the three b_k').  8 lanes a block
// run fastest at the paths' 255 lanes (4 and 2 are 15-29 % slower there,
// 16 12 %; chip_cios_unroll.py, PERF.md §6).
constexpr int kCycLanes = 8;
constexpr int kCycTeam = 9;
constexpr int kCycSlots = 15;

#define SQR_PAIR(x, y, o)                                                    \
  {{x, kNoSlot, kNoSlot, kNoSlot}, {x, kNoSlot, kNoSlot, kNoSlot}, o},       \
  {{y, kNoSlot, kNoSlot, kNoSlot}, {y, kNoSlot, kNoSlot, kNoSlot}, o + 1},   \
  {{x, y, kNoSlot, kNoSlot}, {x, y, kNoSlot, kNoSlot}, o + 2}

__constant__ Prod kCycProds[9] = {SQR_PAIR(4, 0, 6), SQR_PAIR(2, 3, 9),
                                  SQR_PAIR(5, 1, 12)};

template <int N>
__global__ void __launch_bounds__(kCycLanes * kCycTeam)
    f6_cyc_sqr_kernel(Field<N> f, const uint32_t* __restrict__ a,
                      uint32_t* __restrict__ out, int64_t n) {
  constexpr int G = kCycLanes;
  __shared__ uint32_t sm[kCycSlots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(6, base, n, [&](int c, int g) {
      s.put(c, g, ld<N>(a, c, n, base + g));
    });
    __syncthreads();
    prod_stage<N, G>(f, s, kCycProds, 9, base, n);
    __syncthreads();
    team_for<G>(3, base, n, [&](int k, int g) {   // a_k' = 3 t - 2 a_k
      const Fe<N> t = add(f, mul_small(f, s.get(6 + 3 * k, g), kNR),
                          s.get(7 + 3 * k, g));
      const Fe<N> ak = s.get(k, g);
      st<N>(out, k, n, base + g,
            sub(f, add(f, add(f, t, t), t), add(f, ak, ak)));
    });
    team_for<G>(3, base, n, [&](int j, int g) {   // b_j' = 3 c + 2 b_j
      const int r = 6 + 3 * ((j + 2) % 3);          // the pair of b_j'
      const Fe<N> cross = sub(f, sub(f, s.get(r + 2, g), s.get(r, g)),
                              s.get(r + 1, g));
      const Fe<N> c = select(j == 0, mul_small(f, cross, kNR), cross);
      const Fe<N> bj = s.get(3 + j, g);
      st<N>(out, 3 + j, n, base + g,
            add(f, add(f, add(f, c, c), c), add(f, bj, bj)));
    }, warp_after(3, G));
    __syncthreads();
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
// G = X D, H = F - 2G - E; X' = lm H, Y' = th (G - H) - E Y, Z' = Z E,
// each square a product of the value with itself as in the formula.  Out:
// (a0, b, X', Y', Z') [15, L, n].
//
// By a team of kAddTeam threads per lane over kAddLanes lanes a block, in
// four levels of F3 products (84 base products, at most 30 a level), each
// followed by its combine:
//   P1  y2 Z, x2 Z                          -> th, lm
//   P2  lm yP, th xP (in Fp), th x2, y2 lm, th th, lm lm
//                                           -> a0, b, C, D
//   P3  lm D, Z C, X D                      -> E, F, G; then H, G - H
//   P4  lm H, th (G - H), E Y, Z E          -> X', Y', Z'
// P3's combine is two stages, since H and G - H take the coefficients of
// three products.  Slots: X 0, Y 3, Z 6, x2 9, y2 12, xP 15, yP 16, th 17,
// lm 20, C 23 (then F), D 26 (then G), E 29, H 32, G - H 35, and the raw
// base products of the level in flight from kAddRaw (30 slots).
constexpr int kAddLanes = 4;
constexpr int kAddTeam = 30;
constexpr int kAddRaw = 38;
constexpr int kAddSlots = kAddRaw + 30;

__constant__ Prod kAddProds[84] = {
    // P1
    F3_PRODS(12, 6, kAddRaw), F3_PRODS(9, 6, kAddRaw + 6),
    // P2
    F3_SCAL(20, 16, kAddRaw), F3_SCAL(17, 15, kAddRaw + 3),
    F3_PRODS(17, 9, kAddRaw + 6), F3_PRODS(12, 20, kAddRaw + 12),
    F3_PRODS(17, 17, kAddRaw + 18), F3_PRODS(20, 20, kAddRaw + 24),
    // P3
    F3_PRODS(20, 26, kAddRaw), F3_PRODS(6, 23, kAddRaw + 6),
    F3_PRODS(0, 26, kAddRaw + 12),
    // P4
    F3_PRODS(20, 32, kAddRaw), F3_PRODS(17, 35, kAddRaw + 6),
    F3_PRODS(29, 3, kAddRaw + 12), F3_PRODS(6, 29, kAddRaw + 18)};
__constant__ int kAddLevel[5] = {0, 12, 42, 60, 84};   // P1-P4 in kAddProds

template <int N, int G>
__device__ __forceinline__ void add_combine(const Field<N>& f,
                                            const Slots<N, G>& s, int level,
                                            uint32_t* __restrict__ out,
                                            int64_t base, int64_t n) {
  constexpr int r = kAddRaw;
  switch (level) {
    case 0:
      team_for<G>(6, base, n, [&](int c, int g) {   // th = y2Z - Y, lm = x2Z - X
        const int k = c % 3;
        s.put(17 + c, g, sub(f, f3_coef<N, G>(f, s, r + 6 * (c / 3), k, g),
                             s.get((c < 3 ? 3 : 0) + k, g)));
      });
      break;
    case 1:
      team_for<G>(6, base, n, [&](int c, int g) {   // C = th th, D = lm lm
        s.put(23 + c, g, f3_coef<N, G>(f, s, r + 18 + 6 * (c / 3), c % 3, g));
      });
      team_for<G>(3, base, n, [&](int k, int g) {   // a0 = v^2 (lm yP)
        const Fe<N> t = s.get(r + (k + 1) % 3, g);
        st<N>(out, k, n, base + g, select(k == 2, t, mul_small(f, t, kNR)));
      }, kWarp);
      team_for<G>(3, base, n, [&](int k, int g) {   // b = th x2 - (y2 lm + v th xP)
        // the sum first: one coefficient live at a time keeps the kernel
        // from spilling
        Fe<N> y = f3_coef<N, G>(f, s, r + 12, k, g);
        const Fe<N> t = s.get(r + 3 + (k + 2) % 3, g);
        y = add(f, y, select(k == 0, mul_small(f, t, kNR), t));
        st<N>(out, 3 + k, n, base + g,
              sub(f, f3_coef<N, G>(f, s, r + 6, k, g), y));
      }, 2 * kWarp);
      break;
    case 2:
      team_for<G>(9, base, n, [&](int c, int g) {   // E, F over C, G over D
        const int i = c / 3;
        s.put((i == 0 ? 29 : 20 + 3 * i) + c % 3, g,
              f3_coef<N, G>(f, s, r + 6 * i, c % 3, g));
      });
      __syncthreads();
      team_for<G>(6, base, n, [&](int c, int g) {   // H = F - 2G - E, G - H
        const int k = c % 3;
        const Fe<N> gk = s.get(26 + k, g);
        const Fe<N> h = sub(f, sub(f, s.get(23 + k, g), add(f, gk, gk)),
                            s.get(29 + k, g));
        s.put(32 + c, g, select(c < 3, h, sub(f, gk, h)));
      });
      break;
    default:
      team_for<G>(6, base, n, [&](int c, int g) {   // X' = lm H, Z' = Z E
        const int i = c / 3;
        st<N>(out, 6 + 6 * i + c % 3, n, base + g,
              f3_coef<N, G>(f, s, r + 18 * i, c % 3, g));
      });
      team_for<G>(3, base, n, [&](int k, int g) {   // Y' = th (G - H) - E Y
        st<N>(out, 9 + k, n, base + g,
              sub(f, f3_coef<N, G>(f, s, r + 6, k, g),
                  f3_coef<N, G>(f, s, r + 12, k, g)));
      }, kWarp);
  }
}

template <int N>
__global__ void __launch_bounds__(kAddLanes * kAddTeam)
    mnt_miller_add_kernel(Field<N> f, const uint32_t* __restrict__ xyz,
                          const uint32_t* __restrict__ q,
                          const uint32_t* __restrict__ p,
                          uint32_t* __restrict__ out, int64_t n) {
  constexpr int G = kAddLanes;
  __shared__ uint32_t sm[kAddSlots * Slots<N, G>::kStride];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(17, base, n, [&](int c, int g) {   // X, Y, Z, x2, y2, xP, yP
      const uint32_t* src = c < 9 ? xyz : c < 15 ? q : p;
      s.put(c, g, ld<N>(src, c < 9 ? c : c < 15 ? c - 9 : c - 15, n,
                        base + g));
    });
    __syncthreads();
#pragma unroll 1
    for (int level = 0; level < 4; ++level) {
      prod_stage<N, G>(f, s, kAddProds + kAddLevel[level],
                       kAddLevel[level + 1] - kAddLevel[level], base, n);
      __syncthreads();
      add_combine<N, G>(f, s, level, out, base, n);
      __syncthreads();
    }
  }
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
  f6_sqr_kernel<kN><<<team_grid(n, kSqrLanes), kSqrLanes * kSqrTeam, 0,
                      (cudaStream_t)stream>>>(
      f, (const uint32_t*)a, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k13_f6_cyc_sqr(const void* a, void* out, long long n, int n_limbs,
                   const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  f6_cyc_sqr_kernel<kN><<<team_grid(n, kCycLanes), kCycLanes * kCycTeam, 0,
                          (cudaStream_t)stream>>>(
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
      <<<team_grid(n, kAddLanes), kAddLanes * kAddTeam, 0,
         (cudaStream_t)stream>>>(
          f, (const uint32_t*)xyz, (const uint32_t*)q, (const uint32_t*)p,
          (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// Threads a block of the kernels above, in the order of their entry points
// (k12_f6_mul, k12_f6_sqr, k13_f6_cyc_sqr, k14_mnt_miller_dbl,
// k14_mnt_miller_add): the occupancy report of chip_cios_unroll.py.
void mnt_block_threads(int* threads) {
  const int t[5] = {kK12Lanes * kK12Team, kSqrLanes * kSqrTeam,
                    kCycLanes * kCycTeam,
                    kDblLanes * kDblTeam, kAddLanes * kAddTeam};
  for (int k = 0; k < 5; ++k) threads[k] = t[k];
}

}  // extern "C"
