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
//
// What bounds them on the H100: a complete add is ~16 (madd ~11) Montgomery
// products plus the 6 of the doubling fallback, each ~2N^2 IMAD
// instructions, against at most 9 planes of 64 bytes moved, so they are
// bound by integer issue, not by bytes.  Design now: one thread per lane,
// every intermediate in registers (the fused form keeps all of them out of
// device memory, as the Pallas kernels keep them out of HBM); the doubling
// fallback is computed for every lane, as the TPU kernels do, so no warp
// diverges.  Register pressure (~40 live elements of 8 words) is the known
// cost of this simple form.
//
// Built per word count (fp.cuh, WORDS): N = 8 for BN128's G1, N = 12 for
// BLS12-381's (half as many words again in every live element).

#include "fp.cuh"

namespace {

template <int N>
struct Jac {
  Fe<N> x, y, z;
};

template <int N>
__device__ __forceinline__ Jac<N> raw_double(const Field<N>& f, const Fe<N>& X,
                                             const Fe<N>& Y, const Fe<N>& Z) {
  Fe<N> A = mont_mul(f, X, X);
  Fe<N> B = mont_mul(f, Y, Y);
  Fe<N> C = mont_mul(f, B, B);
  Fe<N> xb = add(f, X, B);
  Fe<N> D = sub(f, sub(f, mont_mul(f, xb, xb), A), C);
  D = add(f, D, D);
  Fe<N> E = add(f, add(f, A, A), A);
  Fe<N> G = mont_mul(f, E, E);
  Jac<N> r;
  r.x = sub(f, G, add(f, D, D));
  Fe<N> c8 = add(f, C, C);
  c8 = add(f, c8, c8);
  c8 = add(f, c8, c8);
  r.y = sub(f, mont_mul(f, E, sub(f, D, r.x)), c8);
  Fe<N> yz = mont_mul(f, Y, Z);
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

template <int N>
__global__ void jac_add_kernel(Field<N> f, const uint32_t* __restrict__ x1,
                               const uint32_t* __restrict__ y1,
                               const uint32_t* __restrict__ z1,
                               const uint32_t* __restrict__ x2,
                               const uint32_t* __restrict__ y2,
                               const uint32_t* __restrict__ z2,
                               uint32_t* __restrict__ ox,
                               uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, int64_t n) {
  LANE_LOOP(i, n) {
    Jac<N> P{load_fe<N>(x1, n, i), load_fe<N>(y1, n, i), load_fe<N>(z1, n, i)};
    Jac<N> Q{load_fe<N>(x2, n, i), load_fe<N>(y2, n, i), load_fe<N>(z2, n, i)};
    Fe<N> Z1Z1 = mont_mul(f, P.z, P.z);
    Fe<N> Z2Z2 = mont_mul(f, Q.z, Q.z);
    Fe<N> U1 = mont_mul(f, P.x, Z2Z2);
    Fe<N> U2 = mont_mul(f, Q.x, Z1Z1);
    Fe<N> S1 = mont_mul(f, P.y, mont_mul(f, Q.z, Z2Z2));
    Fe<N> S2 = mont_mul(f, Q.y, mont_mul(f, P.z, Z1Z1));
    Fe<N> H = sub(f, U2, U1);
    Fe<N> r = sub(f, S2, S1);
    r = add(f, r, r);
    Fe<N> HH = add(f, H, H);
    Fe<N> I = mont_mul(f, HH, HH);
    Fe<N> J = mont_mul(f, H, I);
    Fe<N> V = mont_mul(f, U1, I);
    Jac<N> G;
    G.x = sub(f, sub(f, mont_mul(f, r, r), J), add(f, V, V));
    Fe<N> S1J = mont_mul(f, S1, J);
    G.y = sub(f, mont_mul(f, r, sub(f, V, G.x)), add(f, S1J, S1J));
    Fe<N> z12 = add(f, P.z, Q.z);
    G.z = mont_mul(f, sub(f, sub(f, mont_mul(f, z12, z12), Z1Z1), Z2Z2), H);

    Jac<N> D = raw_double(f, P.x, P.y, P.z);
    bool p_zero = is_zero(P.z), q_zero = is_zero(Q.z);
    bool h_zero = is_zero(H), r_zero = is_zero(r);
    Jac<N> zero{fe_zero<N>(), fe_one(f), fe_zero<N>()};

    Jac<N> o = pick(h_zero && r_zero, D, G);
    o = pick(h_zero && !r_zero, zero, o);
    o = pick(q_zero, P, o);
    o = pick(p_zero, Q, o);
    store_fe(ox, n, i, o.x);
    store_fe(oy, n, i, o.y);
    store_fe(oz, n, i, o.z);
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
  jac_add_kernel<kN><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
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

}  // extern "C"
