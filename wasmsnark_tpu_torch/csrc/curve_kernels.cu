// K5-K7: complete Jacobian group law on y^2 = x^3 + b over Fp (G1), for
// Hopper (sm_90a).
//
// K5 jac_madd replaces wasmsnark_tpu/ops/curve_pallas.py _jac_madd_kernel:
//    Jacobian + affine (madd-2007-bl), affine zero written (0, 0).
// K6 jac_add  replaces curve_pallas.py _jac_add_kernel: Jacobian + Jacobian
//    (add-2007-bl with the dbl-2009-l fallback).
// K7 jac_dbl  replaces curve_pallas.py _jac_dbl_kernel: dbl-2009-l, Z = 0
//    passes through unchanged; one launch doubles `times` times, as the
//    JAX package's window fold runs a window's doublings in one fori_loop
//    (wasmsnark_tpu/ops/msm.py fold_windows_device).
//
// The masks are those of the Pallas kernels, in the same order: P = Q falls
// back to doubling, P = -Q gives the zero point (0, one, 0), a zero operand
// returns the other one (an affine (0, 0) is promoted to (0, one, 0)).
// Every value is canonical (< q), so another order of products, or a
// product replaced by the operand it equals, gives the same bits.
//
// What bounds them on the H100: a complete add is ~16 (madd ~11) Montgomery
// products plus the 7 of the doubling, each ~2N^2 IMAD instructions,
// against at most 9 planes of 64 bytes moved, so they are bound by integer
// issue, not by bytes.
//
// K5 and K6 run one thread a lane: the prove launches them on one to two
// million lanes (the MSM's bucket and triangle scans), which fill the card
// many times over, so what a thread does sets the pace.  They are shaped
// for that throughput:
//  - a lane branches: a zero operand copies the other one, P = +-Q (H = 0)
//    takes the doubling or the zero point, and only the other lanes run
//    the add, so the doubling's 7 products run only on the lanes whose
//    output is the doubling (P = Q, both non-zero), which a warp of
//    random buckets almost never holds;
//  - K5's P is, on the prove's path, a promoted affine point (the bucket
//    scan's first step, ops/scan.py): where Z1 is Montgomery one, Z1^2 =
//    Z1^3 = one, so U2 = X2, S2 = Y2 and Z3 = 2H, and the lane's add takes
//    6 products instead of 11; a general Z1 (ops/fixed_base.py) takes
//    the Pallas kernel's products;
//  - their products are the no-carry CIOS (fp.cuh mont_mul_nc);
//  - few values are live at once: the products run in an order that lets
//    each intermediate die early, the values that are needed again only
//    at the end wait in shared memory, and each output coordinate is
//    stored as soon as it is known.  A thread then fits the register cap
//    of two (12 words) or three (8 words) 256-thread blocks an SM, with
//    a few dozen bytes spilled, and the blocks hide each other's
//    multiply-add chains.  Fewer registers, or reading the inputs again
//    from device memory, spilled more and ran slower (PERF.md §6).
//
// K7 is a team kernel (team.cuh): the prove launches it only in the G1
// window fold, on the 4 lanes of its four MSMs, where one thread's chain
// of 7 dependent products a doubling, and a launch a doubling, set the
// time.  dbl-2009-l has three levels of products, so a team of three
// threads a lane runs a doubling in three product stages, and the lane's
// point stays in shared memory for all `times` doublings.
//
// Built per word count (fp.cuh, WORDS): N = 8 for BN128's G1, N = 12 for
// BLS12-381's (half as many words again in every live element).

#include "team.cuh"

namespace {

template <int N>
struct Jac {
  Fe<N> x, y, z;
};

template <int N>
__device__ __forceinline__ Fe<N> mul_nc(const Field<N>& f, const Fe<N>& a,
                                        const Fe<N>& b) {
  return mont_mul_nc<N>(f, a, [&](int i) { return b.w[i]; });
}

template <int N>
__device__ __forceinline__ Fe<N> sqr_nc(const Field<N>& f, const Fe<N>& a) {
  return mul_nc(f, a, a);
}

template <int N>
__device__ __forceinline__ bool is_one(const Field<N>& f, const Fe<N>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc |= a.w[k] ^ f.one[k];
  return acc == 0;
}

// dbl-2009-l, the doubling of K5 and K6 where P = Q.
template <int N>
__device__ __forceinline__ Jac<N> raw_double(const Field<N>& f, const Fe<N>& X,
                                             const Fe<N>& Y, const Fe<N>& Z) {
  Fe<N> A = sqr_nc(f, X);
  Fe<N> B = sqr_nc(f, Y);
  Fe<N> C = sqr_nc(f, B);
  Fe<N> xb = add(f, X, B);
  Fe<N> D = sub(f, sub(f, sqr_nc(f, xb), A), C);
  D = add(f, D, D);
  Fe<N> E = add(f, add(f, A, A), A);
  Fe<N> G = sqr_nc(f, E);
  Jac<N> r;
  r.x = sub(f, G, add(f, D, D));
  Fe<N> c8 = add(f, C, C);
  c8 = add(f, c8, c8);
  c8 = add(f, c8, c8);
  r.y = sub(f, mul_nc(f, E, sub(f, D, r.x)), c8);
  Fe<N> yz = mul_nc(f, Y, Z);
  r.z = add(f, yz, yz);
  return r;
}

template <int N>
__device__ __forceinline__ void store_jac(uint32_t* __restrict__ ox,
                                          uint32_t* __restrict__ oy,
                                          uint32_t* __restrict__ oz,
                                          int64_t n, int64_t i,
                                          const Fe<N>& x, const Fe<N>& y,
                                          const Fe<N>& z) {
  store_fe(ox, n, i, x);
  store_fe(oy, n, i, y);
  store_fe(oz, n, i, z);
}

// The block of K5 and K6: threads, and the blocks an SM must hold, which
// caps a thread's registers at 65,536 / (kAddThreads * kAddMinBlocks): 128
// at 12 words, 80 at 8.
constexpr int kAddThreads = 256;
constexpr int kAddMinBlocks = kN == 8 ? 3 : 2;

// A thread's parking slot in shared memory for a value it needs again much
// later: word k of thread x at p[k * kAddThreads + x], read and written
// through volatile pointers, so that the compiler does not keep the value
// in registers all the same.
template <int N>
struct Park {
  volatile uint32_t* p;
  __device__ __forceinline__ void put(const Fe<N>& a) const {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k * kAddThreads] = a.w[k];
  }
  __device__ __forceinline__ Fe<N> get() const {
    Fe<N> a;
#pragma unroll
    for (int k = 0; k < N; ++k) a.w[k] = p[k * kAddThreads];
    return a;
  }
};

// add-2007-bl with dbl-2009-l where P = Q, one lane a thread.  The
// products run in an order in which few elements are live at once: Z1 Z2
// first (Z3 = 2 Z1 Z2 H is the formula's ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H,
// one element kept instead of two), U1 and S1 from Z2^2, r and H from
// Z1^2; then Z3; I, V and J; X3 and Y3.  Z1 Z2, U1 and S1, needed again
// only after H and r, wait in the thread's parking slots.
template <int N>
__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
    jac_add_kernel(Field<N> f, const uint32_t* __restrict__ x1,
                   const uint32_t* __restrict__ y1,
                   const uint32_t* __restrict__ z1,
                   const uint32_t* __restrict__ x2,
                   const uint32_t* __restrict__ y2,
                   const uint32_t* __restrict__ z2,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz, int64_t n) {
  __shared__ uint32_t park[3 * N * kAddThreads];
  const Park<N> pzz{park + threadIdx.x},
      pu1{park + N * kAddThreads + threadIdx.x},
      ps1{park + 2 * N * kAddThreads + threadIdx.x};
  LANE_LOOP(i, n) {
    auto in = [&](const uint32_t* __restrict__ p) {
      return load_fe<N>(p, n, i);
    };
    const Fe<N> Z1 = in(z1), Z2 = in(z2);
    const bool p_zero = is_zero(Z1);
    if (p_zero || is_zero(Z2)) {      // Q if P is zero, else P, as given
      store_fe(ox, n, i, in(p_zero ? x2 : x1));
      store_fe(oy, n, i, in(p_zero ? y2 : y1));
      store_fe(oz, n, i, p_zero ? Z2 : Z1);
      continue;
    }
    pzz.put(mul_nc(f, Z1, Z2));
    Fe<N> t = sqr_nc(f, Z2);
    pu1.put(mul_nc(f, in(x1), t));
    t = mul_nc(f, Z2, t);
    ps1.put(mul_nc(f, in(y1), t));
    const Fe<N> B = sqr_nc(f, Z1);
    t = mul_nc(f, Z1, B);
    Fe<N> r = sub(f, mul_nc(f, in(y2), t), ps1.get());
    r = add(f, r, r);
    const Fe<N> H = sub(f, mul_nc(f, in(x2), B), pu1.get());
    if (is_zero(H)) {
      if (is_zero(r)) {               // P = Q: dbl-2009-l
        const Jac<N> d = raw_double(f, in(x1), in(y1), Z1);
        store_fe(ox, n, i, d.x);
        store_fe(oy, n, i, d.y);
        store_fe(oz, n, i, d.z);
      } else {                        // P = -Q: the zero point (0, one, 0)
        store_fe(ox, n, i, fe_zero<N>());
        store_fe(oy, n, i, fe_one(f));
        store_fe(oz, n, i, fe_zero<N>());
      }
      continue;
    }
    t = pzz.get();
    store_fe(oz, n, i, mul_nc(f, add(f, t, t), H));
    const Fe<N> I = sqr_nc(f, add(f, H, H));
    const Fe<N> V = mul_nc(f, pu1.get(), I);
    const Fe<N> J = mul_nc(f, H, I);
    const Fe<N> X3 = sub(f, sub(f, sqr_nc(f, r), J), add(f, V, V));
    store_fe(ox, n, i, X3);
    t = mul_nc(f, ps1.get(), J);
    store_fe(oy, n, i, sub(f, mul_nc(f, r, sub(f, V, X3)), add(f, t, t)));
  }
}

// dbl-2009-l of (X, Y, Z) stored as each coordinate is known, Z3 first so
// that Y and Z die early: four elements live at most, where raw_double
// holds six (K5's P = Q lanes).
template <int N>
__device__ __forceinline__ void double_store(
    const Field<N>& f, const Fe<N>& X, const Fe<N>& Y, const Fe<N>& Z,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, int64_t n, int64_t i) {
  Fe<N> t = mul_nc(f, Y, Z);
  store_fe(oz, n, i, add(f, t, t));
  const Fe<N> A = sqr_nc(f, X);
  const Fe<N> B = sqr_nc(f, Y);
  const Fe<N> C = sqr_nc(f, B);
  Fe<N> D = sub(f, sub(f, sqr_nc(f, add(f, X, B)), A), C);
  D = add(f, D, D);
  const Fe<N> E = add(f, add(f, A, A), A);
  const Fe<N> X3 = sub(f, sqr_nc(f, E), add(f, D, D));
  store_fe(ox, n, i, X3);
  t = add(f, C, C);
  t = add(f, t, t);
  t = add(f, t, t);
  store_fe(oy, n, i, sub(f, mul_nc(f, E, sub(f, D, X3)), t));
}

// madd-2007-bl with dbl-2009-l where P = Q, one lane a thread, branched by
// lane kind:
//  - P zero: promote(Q), (X2, Y2, one), or (0, one, 0) for Q = (0, 0);
//  - Q the affine zero: P as given;
//  - Z1 = one (a promoted affine point): H = X2 - X1, r = 2 (Y2 - Y1),
//    no product; otherwise Z1Z1, U2 = X2 Z1Z1, Z1 Z1Z1 and S2 first;
//  - H = 0: the doubling where r = 0 (P = Q), else the zero point;
//  - else the add: Z3 (2H where Z1 = one, else 2 Z1 H, the Pallas
//    kernel's product), I, J, V, X3, Y3.
// Z1 (on the general lanes), X1 and Y1, needed again after H and r, wait
// in the parking slots.
template <int N>
__global__ void __launch_bounds__(kAddThreads, kAddMinBlocks)
    jac_madd_kernel(Field<N> f, const uint32_t* __restrict__ x1,
                    const uint32_t* __restrict__ y1,
                    const uint32_t* __restrict__ z1,
                    const uint32_t* __restrict__ x2,
                    const uint32_t* __restrict__ y2,
                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                    uint32_t* __restrict__ oz, int64_t n) {
  __shared__ uint32_t park[3 * N * kAddThreads];
  const Park<N> px1{park + threadIdx.x},
      py1{park + N * kAddThreads + threadIdx.x},
      pz1{park + 2 * N * kAddThreads + threadIdx.x};
  LANE_LOOP(i, n) {
    auto in = [&](const uint32_t* __restrict__ p) {
      return load_fe<N>(p, n, i);
    };
    const Fe<N> Z1 = in(z1), X2 = in(x2), Y2 = in(y2);
    const bool q_zero = is_zero(X2) && is_zero(Y2);
    if (is_zero(Z1)) {                // promote(Q)
      store_jac(ox, oy, oz, n, i, X2, select(q_zero, fe_one(f), Y2),
                select(q_zero, fe_zero<N>(), fe_one(f)));
      continue;
    }
    if (q_zero) {                     // P, as given
      store_jac(ox, oy, oz, n, i, in(x1), in(y1), Z1);
      continue;
    }
    const bool z_one = is_one(f, Z1);
    Fe<N> H, r;
    if (z_one) {
      H = sub(f, X2, in(x1));
      r = sub(f, Y2, in(y1));
    } else {
      pz1.put(Z1);
      Fe<N> t = sqr_nc(f, Z1);
      H = sub(f, mul_nc(f, X2, t), in(x1));
      t = mul_nc(f, Z1, t);
      r = sub(f, mul_nc(f, Y2, t), in(y1));
    }
    r = add(f, r, r);
    if (is_zero(H)) {
      if (is_zero(r))                 // P = Q: dbl-2009-l
        double_store(f, in(x1), in(y1), z_one ? fe_one(f) : pz1.get(), ox,
                     oy, oz, n, i);
      else                            // P = -Q: the zero point (0, one, 0)
        store_jac(ox, oy, oz, n, i, fe_zero<N>(), fe_one(f), fe_zero<N>());
      continue;
    }
    px1.put(in(x1));
    py1.put(in(y1));
    const Fe<N> h2 = add(f, H, H);
    if (z_one) {
      store_fe(oz, n, i, h2);
    } else {
      const Fe<N> z = pz1.get();
      store_fe(oz, n, i, mul_nc(f, add(f, z, z), H));
    }
    const Fe<N> I = sqr_nc(f, h2);
    const Fe<N> J = mul_nc(f, H, I);
    const Fe<N> V = mul_nc(f, px1.get(), I);
    const Fe<N> X3 = sub(f, sub(f, sqr_nc(f, r), J), add(f, V, V));
    store_fe(ox, n, i, X3);
    const Fe<N> t = mul_nc(f, py1.get(), J);
    store_fe(oy, n, i, sub(f, mul_nc(f, r, sub(f, V, X3)), add(f, t, t)));
  }
}

// K7: dbl-2009-l `times` times by a team of kK7Team threads a lane over
// kK7Lanes lanes a block, the lane's point in shared memory throughout.
// A doubling is three stages of at most one product a thread, its
// operands sums of slots (team.cuh Prod) formed in registers:
//   P1  A = X^2, B = Y^2, YZ = Y Z
//   P2  C = B^2, T = (X + B)^2, G = E^2 with E = 3A (A + A + A)
//   P3  D = 2 (T - A - C), X3 = G - 2D and E (D - X3); -8C; Z3 = 2 YZ
// and Y3 = E (D - X3) - 8C is left as the sum of two slots, which the
// next doubling's P1 takes as its operand and the last store adds.  Each
// value is dbl-2009-l's field element (E (D - X3) + (-8C) mod q is
// E (D - X3) - 8C), so the point is the Pallas kernel's representative.
// A lane whose Z is zero keeps its point: P1 finds Z = 0 and marks the
// lane (live[g], written alike by P1's three items) for P2 and P3 to
// leave out.  Slots: X, Z, A, B, YZ, C, T, G, -8C, E (D - X3); Y is the
// sum of the last two, loaded as (Y, 0).  A block serves kK7Lanes = 8
// lanes (24 threads): on the window fold's 4 lanes one warp's chain of
// products sets the time whether they share a block or take one each
// (within 1 %), and at 2^16 lanes 8 a block run 8x faster than one
// (PERF.md §6).
constexpr int kK7Lanes = 8;
constexpr int kK7Team = 3;
enum K7Slot : uint8_t {
  kSX, kSZ, kSA, kSB, kSYZ, kSC, kST, kSG, kSM8C, kSP, kK7Slots
};
constexpr uint8_t kNo = kNoSlot;

__constant__ Prod kK7Prods[6] = {
    // P1: X X, (P + M8C)(P + M8C), (P + M8C) Z
    {{kSX, kNo, kNo, kNo}, {kSX, kNo, kNo, kNo}, kSA},
    {{kSP, kSM8C, kNo, kNo}, {kSP, kSM8C, kNo, kNo}, kSB},
    {{kSP, kSM8C, kNo, kNo}, {kSZ, kNo, kNo, kNo}, kSYZ},
    // P2: B B, (X + B)(X + B), 3A 3A
    {{kSB, kNo, kNo, kNo}, {kSB, kNo, kNo, kNo}, kSC},
    {{kSX, kSB, kNo, kNo}, {kSX, kSB, kNo, kNo}, kST},
    {{kSA, kSA, kSA, kNo}, {kSA, kSA, kSA, kNo}, kSG}};

// Product pr of lane g, its operands in registers (a square sums once).
template <int N, int G>
__device__ __forceinline__ void k7_prod(const Field<N>& f,
                                        const Slots<N, G>& s, const Prod& pr,
                                        int g) {
  const Fe<N> a = s.sum(f, pr.a, g);
  bool sq = true;
#pragma unroll
  for (int r = 0; r < 4; ++r) sq &= pr.a[r] == pr.b[r];
  s.put(pr.out, g, mul_nc(f, a, sq ? a : s.sum(f, pr.b, g)));
}

template <int N, int G>
__global__ void __launch_bounds__(kK7Team * G)
    jac_dbl_kernel(Field<N> f, const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ y,
                   const uint32_t* __restrict__ z,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz, int64_t n, int times) {
  __shared__ uint32_t sm[kK7Slots * Slots<N, G>::kStride];
  __shared__ int live[G];
  const Slots<N, G> s{sm};
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(3, base, n, [&](int c, int g) {   // X, (Y, 0), Z
      const int64_t i = base + g;
      if (c == 0) {
        s.put(kSX, g, load_fe<N>(x, n, i));
      } else if (c == 1) {
        s.put(kSP, g, load_fe<N>(y, n, i));
        s.put(kSM8C, g, fe_zero<N>());
      } else {
        s.put(kSZ, g, load_fe<N>(z, n, i));
      }
    });
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < times; ++t) {
      team_for<G>(3, base, n, [&](int it, int g) {
        const bool go = !is_zero(s.get(kSZ, g));
        live[g] = go;
        if (go) {
          const Prod pr = kK7Prods[it];
          k7_prod<N, G>(f, s, pr, g);
        }
      });
      __syncthreads();
      team_for<G>(3, base, n, [&](int it, int g) {
        if (live[g]) {
          const Prod pr = kK7Prods[3 + it];
          k7_prod<N, G>(f, s, pr, g);
        }
      });
      __syncthreads();
      team_for<G>(3, base, n, [&](int c, int g) {
        if (!live[g]) return;
        if (c == 0) {                             // X3, E (D - X3)
          const Fe<N> A = s.get(kSA, g);
          Fe<N> D = sub(f, sub(f, s.get(kST, g), A), s.get(kSC, g));
          D = add(f, D, D);
          const Fe<N> X3 = sub(f, s.get(kSG, g), add(f, D, D));
          s.put(kSX, g, X3);
          s.put(kSP, g, mul_nc(f, add(f, add(f, A, A), A), sub(f, D, X3)));
        } else if (c == 1) {                      // -8C
          Fe<N> c8 = s.get(kSC, g);
          c8 = add(f, c8, c8);
          c8 = add(f, c8, c8);
          c8 = add(f, c8, c8);
          s.put(kSM8C, g, sub(f, fe_zero<N>(), c8));
        } else {                                  // Z3 = 2 YZ
          const Fe<N> yz = s.get(kSYZ, g);
          s.put(kSZ, g, add(f, yz, yz));
        }
      });
      __syncthreads();
    }
    team_for<G>(3, base, n, [&](int c, int g) {   // X, P + (-8C), Z
      const int64_t i = base + g;
      if (c == 0)
        store_fe(ox, n, i, s.get(kSX, g));
      else if (c == 1)
        store_fe(oy, n, i, add(f, s.get(kSP, g), s.get(kSM8C, g)));
      else
        store_fe(oz, n, i, s.get(kSZ, g));
    });
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int k5_jac_madd(const void* x1, const void* y1, const void* z1, const void* x2,
                const void* y2, void* ox, void* oy, void* oz, long long n,
                int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  jac_madd_kernel<kN><<<grid_for(n, kAddThreads), kAddThreads, 0,
                        (cudaStream_t)stream>>>(
      f, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (uint32_t*)ox, (uint32_t*)oy,
      (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int k6_jac_add(const void* x1, const void* y1, const void* z1, const void* x2,
               const void* y2, const void* z2, void* ox, void* oy, void* oz,
               long long n, int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  jac_add_kernel<kN><<<grid_for(n, kAddThreads), kAddThreads, 0,
                       (cudaStream_t)stream>>>(
      f, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

// times >= 1 doublings of each lane's point in one launch.
int k7_jac_dbl(const void* x, const void* y, const void* z, void* ox, void* oy,
               void* oz, long long n, long long times, int n_limbs,
               const void* consts, void* stream) {
  if (bad_args(n_limbs, n) || times < 1 || times > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  jac_dbl_kernel<kN, kK7Lanes>
      <<<team_grid(n, kK7Lanes), kK7Team * kK7Lanes, 0,
         (cudaStream_t)stream>>>(
          f, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
          (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, (int)times);
  return (int)cudaGetLastError();
}

// Threads a block of k5_jac_madd, k6_jac_add and k7_jac_dbl: the occupancy
// report of chip_cios_unroll.py.
void curve_block_threads(int* threads) {
  const int t[3] = {kAddThreads, kAddThreads, kK7Team * kK7Lanes};
  for (int k = 0; k < 3; ++k) threads[k] = t[k];
}

// The entry points' revision, for a caller that binds libraries built
// from older sources too: 2 since k7_jac_dbl takes `times` (a library
// without this symbol has k7_jac_dbl(x, y, z, ox, oy, oz, n, n_limbs,
// consts, stream), one doubling a launch).
int curve_kernels_revision(void) { return 2; }

}  // extern "C"
