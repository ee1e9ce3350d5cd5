// K5-K7: complete Jacobian group law on y^2 = x^3 + b over Fp (G1), for
// Hopper (sm_90a).
//
// K5 jac_madd replaces wasmsnark_tpu/ops/curve_pallas.py _jac_madd_kernel:
//    Jacobian + affine (madd-2007-bl), affine zero written (0, 0).
// K6 jac_add  replaces curve_pallas.py _jac_add_kernel: Jacobian + Jacobian
//    (add-2007-bl with the dbl-2009-l fallback).
// K7 jac_dbl  replaces curve_pallas.py _jac_dbl_kernel: dbl-2009-l, Z = 0
//    passes through unchanged.
//
// The masks are those of the Pallas kernels, in the same order: P = Q falls
// back to doubling, P = -Q gives the zero point (0, one, 0), a zero operand
// returns the other one (an affine (0, 0) is promoted to (0, one, 0)).
// Every value is canonical (< q), so K6's other order of products gives
// the same bits.
//
// What bounds them on the H100: a complete add is ~16 (madd ~11) Montgomery
// products plus the 7 of the doubling, each ~2N^2 IMAD instructions,
// against at most 9 planes of 64 bytes moved, so they are bound by integer
// issue, not by bytes.  One thread per lane: the prove launches K5 and K6
// on one to two million lanes (the MSM's bucket and triangle scans), which
// fill the card many times over, so what a thread does sets the pace.
//
// K5 and K7 keep every intermediate in registers and compute the doubling
// fallback for every lane, as the TPU kernels do, so no warp diverges.
// K6 is shaped for the triangle scan's throughput instead:
//  - a lane branches: a zero operand copies the other one, P = +-Q (H = 0)
//    takes the doubling or the zero point, and only the other lanes run
//    the add, so the doubling's 7 products run only on the lanes whose
//    output is the doubling (P = Q, both non-zero), which a warp of
//    random buckets almost never holds;
//  - its products are the no-carry CIOS (fp.cuh mont_mul_nc);
//  - few values are live at once: the products run in an order that lets
//    each intermediate die early, the three that are needed again only
//    at the end wait in shared memory, and each output coordinate is
//    stored as soon as it is known.  A thread then fits the register cap
//    of two (12 words) or three (8 words) 256-thread blocks an SM, with
//    a few dozen bytes spilled, and the blocks hide each other's
//    multiply-add chains.  Fewer registers, or reading the inputs again
//    from device memory, spilled more and ran slower (PERF.md §6).
//
// Built per word count (fp.cuh, WORDS): N = 8 for BN128's G1, N = 12 for
// BLS12-381's (half as many words again in every live element).

#include "fp.cuh"

namespace {

template <int N>
struct Jac {
  Fe<N> x, y, z;
};

// The Montgomery product a formula runs: fp.cuh's CIOS (K5, K7) or its
// no-carry form (K6).  Both give the canonical product, so the same bits.
struct Cios {
  template <int N>
  static __device__ __forceinline__ Fe<N> mul(const Field<N>& f,
                                              const Fe<N>& a,
                                              const Fe<N>& b) {
    return mont_mul(f, a, b);
  }
};

struct CiosNc {
  template <int N>
  static __device__ __forceinline__ Fe<N> mul(const Field<N>& f,
                                              const Fe<N>& a,
                                              const Fe<N>& b) {
    return mont_mul_nc<N>(f, a, [&](int i) { return b.w[i]; });
  }
};

template <class M = Cios, int N>
__device__ __forceinline__ Jac<N> raw_double(const Field<N>& f, const Fe<N>& X,
                                             const Fe<N>& Y, const Fe<N>& Z) {
  Fe<N> A = M::mul(f, X, X);
  Fe<N> B = M::mul(f, Y, Y);
  Fe<N> C = M::mul(f, B, B);
  Fe<N> xb = add(f, X, B);
  Fe<N> D = sub(f, sub(f, M::mul(f, xb, xb), A), C);
  D = add(f, D, D);
  Fe<N> E = add(f, add(f, A, A), A);
  Fe<N> G = M::mul(f, E, E);
  Jac<N> r;
  r.x = sub(f, G, add(f, D, D));
  Fe<N> c8 = add(f, C, C);
  c8 = add(f, c8, c8);
  c8 = add(f, c8, c8);
  r.y = sub(f, M::mul(f, E, sub(f, D, r.x)), c8);
  Fe<N> yz = M::mul(f, Y, Z);
  r.z = add(f, yz, yz);
  return r;
}

template <int N>
__device__ __forceinline__ Jac<N> pick(bool c, const Jac<N>& a,
                                       const Jac<N>& b) {
  Jac<N> r;
  r.x = select(c, a.x, b.x);
  r.y = select(c, a.y, b.y);
  r.z = select(c, a.z, b.z);
  return r;
}

// K6's block: threads, and the blocks an SM must hold, which caps a
// thread's registers at 65,536 / (kK6Threads * kK6MinBlocks): 128 at 12
// words, 80 at 8.
constexpr int kK6Threads = 256;
constexpr int kK6MinBlocks = kN == 8 ? 3 : 2;

template <int N>
__device__ __forceinline__ Fe<N> mul_nc(const Field<N>& f, const Fe<N>& a,
                                        const Fe<N>& b) {
  return CiosNc::mul(f, a, b);
}

template <int N>
__device__ __forceinline__ Fe<N> sqr_nc(const Field<N>& f, const Fe<N>& a) {
  return mul_nc(f, a, a);
}

// A thread's parking slot in shared memory for a value it needs again much
// later: word k of thread x at p[k * kK6Threads + x], read and written
// through volatile pointers, so that the compiler does not keep the value
// in registers all the same.
template <int N>
struct Park {
  volatile uint32_t* p;
  __device__ __forceinline__ void put(const Fe<N>& a) const {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k * kK6Threads] = a.w[k];
  }
  __device__ __forceinline__ Fe<N> get() const {
    Fe<N> a;
#pragma unroll
    for (int k = 0; k < N; ++k) a.w[k] = p[k * kK6Threads];
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
__global__ void __launch_bounds__(kK6Threads, kK6MinBlocks)
    jac_add_kernel(Field<N> f, const uint32_t* __restrict__ x1,
                   const uint32_t* __restrict__ y1,
                   const uint32_t* __restrict__ z1,
                   const uint32_t* __restrict__ x2,
                   const uint32_t* __restrict__ y2,
                   const uint32_t* __restrict__ z2,
                   uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                   uint32_t* __restrict__ oz, int64_t n) {
  __shared__ uint32_t park[3 * N * kK6Threads];
  const Park<N> pzz{park + threadIdx.x},
      pu1{park + N * kK6Threads + threadIdx.x},
      ps1{park + 2 * N * kK6Threads + threadIdx.x};
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
        const Jac<N> d = raw_double<CiosNc>(f, in(x1), in(y1), Z1);
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

template <int N>
__global__ void jac_madd_kernel(Field<N> f, const uint32_t* __restrict__ x1,
                                const uint32_t* __restrict__ y1,
                                const uint32_t* __restrict__ z1,
                                const uint32_t* __restrict__ x2,
                                const uint32_t* __restrict__ y2,
                                uint32_t* __restrict__ ox,
                                uint32_t* __restrict__ oy,
                                uint32_t* __restrict__ oz, int64_t n) {
  LANE_LOOP(i, n) {
    Jac<N> P{load_fe<N>(x1, n, i), load_fe<N>(y1, n, i), load_fe<N>(z1, n, i)};
    Fe<N> X2 = load_fe<N>(x2, n, i), Y2 = load_fe<N>(y2, n, i);
    Fe<N> Z1Z1 = mont_mul(f, P.z, P.z);
    Fe<N> U2 = mont_mul(f, X2, Z1Z1);
    Fe<N> S2 = mont_mul(f, Y2, mont_mul(f, P.z, Z1Z1));
    Fe<N> H = sub(f, U2, P.x);
    Fe<N> r = sub(f, S2, P.y);
    r = add(f, r, r);
    Fe<N> HH = add(f, H, H);
    Fe<N> I = mont_mul(f, HH, HH);
    Fe<N> J = mont_mul(f, H, I);
    Fe<N> V = mont_mul(f, P.x, I);
    Jac<N> G;
    G.x = sub(f, sub(f, mont_mul(f, r, r), J), add(f, V, V));
    Fe<N> S1J = mont_mul(f, P.y, J);
    G.y = sub(f, mont_mul(f, r, sub(f, V, G.x)), add(f, S1J, S1J));
    G.z = mont_mul(f, add(f, P.z, P.z), H);

    Jac<N> D = raw_double(f, P.x, P.y, P.z);
    bool p_zero = is_zero(P.z);
    bool q_zero = is_zero(X2) && is_zero(Y2);
    bool h_zero = is_zero(H), r_zero = is_zero(r);
    Fe<N> one = fe_one(f), zf = fe_zero<N>();
    Jac<N> zero{zf, one, zf};
    // promote(Q): (X2, Y2, 1), and (0, one, 0) when Q is the affine zero
    Jac<N> Qj{X2, select(q_zero, one, Y2), select(q_zero, zf, one)};

    Jac<N> o = pick(h_zero && r_zero, D, G);
    o = pick(h_zero && !r_zero, zero, o);
    o = pick(q_zero, P, o);
    o = pick(p_zero, Qj, o);
    store_fe(ox, n, i, o.x);
    store_fe(oy, n, i, o.y);
    store_fe(oz, n, i, o.z);
  }
}

template <int N>
__global__ void jac_dbl_kernel(Field<N> f, const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ y,
                               const uint32_t* __restrict__ z,
                               uint32_t* __restrict__ ox,
                               uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, int64_t n) {
  LANE_LOOP(i, n) {
    Jac<N> P{load_fe<N>(x, n, i), load_fe<N>(y, n, i), load_fe<N>(z, n, i)};
    Jac<N> o = pick(is_zero(P.z), P, raw_double(f, P.x, P.y, P.z));
    store_fe(ox, n, i, o.x);
    store_fe(oy, n, i, o.y);
    store_fe(oz, n, i, o.z);
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
  jac_madd_kernel<kN><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
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
  jac_add_kernel<kN><<<grid_for(n, kK6Threads), kK6Threads, 0,
                       (cudaStream_t)stream>>>(
      f, (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1,
      (const uint32_t*)x2, (const uint32_t*)y2, (const uint32_t*)z2,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

int k7_jac_dbl(const void* x, const void* y, const void* z, void* ox, void* oy,
               void* oz, long long n, int n_limbs, const void* consts,
               void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  jac_dbl_kernel<kN><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n);
  return (int)cudaGetLastError();
}

// Threads a block of k5_jac_madd, k6_jac_add and k7_jac_dbl: the occupancy
// report of chip_cios_unroll.py.
void curve_block_threads(int* threads) {
  const int t[3] = {kThreads, kK6Threads, kThreads};
  for (int k = 0; k < 3; ++k) threads[k] = t[k];
}

}  // extern "C"
