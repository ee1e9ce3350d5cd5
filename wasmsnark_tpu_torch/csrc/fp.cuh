// Prime-field device functions shared by the port's CUDA kernels.
//
// Planes in device memory keep the JAX package's layout: an element of a
// field with L 16-bit limbs is a column of L uint32 words (one limb each,
// values < 2^16), limb-major, so plane k of lane i sits at p[k * n + i].
// Neighbouring threads take neighbouring lanes, so every limb load and
// store is coalesced.  Inside a thread the element is repacked into N =
// L/2 32-bit words and multiplied with 32x32->64-bit products, which is
// the width the H100's integer multiply-add (IMAD.WIDE) works at.
//
// Every function returns canonical values (< q) for canonical inputs, so
// results are bit-identical to the 16-bit-limb plain versions whatever
// the internal representation.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Every library is built once per word count N that its kernels serve,
// given as -DWORDS=N: 8 for the 16-limb fields (BN128 Fp and Fr, BLS12-381
// Fr), 12 for BLS12-381's 24-limb Fq, 24 for MNT6753's 48-limb Fq.  An
// entry point refuses any other limb count.
#ifndef WORDS
#error "build with -DWORDS=<32-bit words per field element>"
#endif
constexpr int kN = WORDS;

inline bool bad_args(int n_limbs, long long n) {
  return n_limbs != 2 * kN || n < 0;
}

template <int N>
struct Field {
  uint32_t q[N];     // modulus, 32-bit words, little-endian
  uint32_t one[N];   // R mod q (Montgomery one), R = 2^(32N)
  uint32_t np;       // -q^{-1} mod 2^32
};

template <int N>
struct Fe {
  uint32_t w[N];
};

// Field constants arrive from Python as 3N + 1 uint32 words: q, one, np,
// then -q^-1 mod 2^(32N) (fp_kernels.cu's K1 team product); this reads
// the first 2N + 1.
template <int N>
inline Field<N> field_from_words(const uint32_t* words) {
  Field<N> f;
  for (int k = 0; k < N; ++k) f.q[k] = words[k];
  for (int k = 0; k < N; ++k) f.one[k] = words[N + k];
  f.np = words[2 * N];
  return f;
}

template <int N>
__device__ __forceinline__ Fe<N> load_fe(const uint32_t* __restrict__ p,
                                         int64_t n, int64_t i) {
  Fe<N> a;
#pragma unroll
  for (int k = 0; k < N; ++k)
    a.w[k] = (p[(2 * k) * n + i] & 0xFFFFu) | (p[(2 * k + 1) * n + i] << 16);
  return a;
}

template <int N>
__device__ __forceinline__ void store_fe(uint32_t* __restrict__ p, int64_t n,
                                         int64_t i, const Fe<N>& a) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p[(2 * k) * n + i] = a.w[k] & 0xFFFFu;
    p[(2 * k + 1) * n + i] = a.w[k] >> 16;
  }
}

template <int N>
__device__ __forceinline__ Fe<N> fe_zero() {
  Fe<N> a;
#pragma unroll
  for (int k = 0; k < N; ++k) a.w[k] = 0;
  return a;
}

template <int N>
__device__ __forceinline__ Fe<N> fe_one(const Field<N>& f) {
  Fe<N> a;
#pragma unroll
  for (int k = 0; k < N; ++k) a.w[k] = f.one[k];
  return a;
}

template <int N>
__device__ __forceinline__ bool is_zero(const Fe<N>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) acc |= a.w[k];
  return acc == 0;
}

template <int N>
__device__ __forceinline__ Fe<N> select(bool c, const Fe<N>& a,
                                        const Fe<N>& b) {
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = c ? a.w[k] : b.w[k];
  return r;
}

// a - q if a >= q else a (a < 2^(32N)).
template <int N>
__device__ __forceinline__ Fe<N> cond_sub_q(const Field<N>& f, const Fe<N>& a) {
  Fe<N> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t t = (uint64_t)a.w[k] - f.q[k] - borrow;
    d.w[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return select(borrow != 0, a, d);
}

// (a + b) mod q; a + b < 2q < 2^(32N) because q has at least two spare bits.
template <int N>
__device__ __forceinline__ Fe<N> add(const Field<N>& f, const Fe<N>& a,
                                     const Fe<N>& b) {
  Fe<N> s;
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t t = (uint64_t)a.w[k] + b.w[k] + carry;
    s.w[k] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return cond_sub_q(f, s);
}

// (a - b) mod q: borrow chain, then add q back when it borrowed.
template <int N>
__device__ __forceinline__ Fe<N> sub(const Field<N>& f, const Fe<N>& a,
                                     const Fe<N>& b) {
  Fe<N> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t t = (uint64_t)a.w[k] - b.w[k] - borrow;
    d.w[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  uint32_t mask = 0u - borrow;
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t t = (uint64_t)d.w[k] + (f.q[k] & mask) + carry;
    d.w[k] = (uint32_t)t;
    carry = (uint32_t)(t >> 32);
  }
  return d;
}

// flag ? (q - a, with -0 = 0) : a.
template <int N>
__device__ __forceinline__ Fe<N> cneg(const Field<N>& f, bool flag,
                                      const Fe<N>& a) {
  return select(flag, sub(f, fe_zero<N>(), a), a);
}

// CIOS Montgomery product a * b * 2^(-32N) mod q.  The accumulator t has
// N + 2 words; with q < 2^(32N - 2) the result before the final subtract
// is < 2q, so one conditional subtract makes it canonical.  Both loops are
// unrolled, unless a source defines FP_CIOS_ROLLED: then the outer loop
// over b's words stays rolled (mnt_kernels.cu, whose build it shortens).  Every field of
// the port meets the bound: BN128 (254 bits < 2^254 at N = 8), BLS12-381
// Fq (381 < 2^382 at N = 12), MNT6753 Fq (753 < 2^766 at N = 24).
template <int N>
__device__ __forceinline__ Fe<N> mont_mul(const Field<N>& f, const Fe<N>& a,
                                          const Fe<N>& b) {
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
#ifdef FP_CIOS_ROLLED
#pragma unroll 1
#else
#pragma unroll
#endif
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);

    uint32_t m = t[0] * f.np;
    s = (uint64_t)m * f.q[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * f.q[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  Fe<N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = t[k];
  return cond_sub_q(f, r);
}

// The base product of the team kernels (team.cuh) and of K6
// (curve_kernels.cu), a * b * 2^(-32N) mod q with b's word i given by
// b_word(i): CIOS without mont_mul's two extra accumulator words
// ("no-carry" CIOS), which holds for a modulus whose top word is below
// 2^31 - 1, as every field of the port's is (q < 2^(32N - 2)).  Per
// word of b the multiply and the reduction run as two interleaved carry
// chains, A and C, instead of one after the other, which halves the
// chain of dependent steps that bounds one thread.  The result before the
// final subtract is < 2q, so it is canonical after it.
template <int N, class Word>
__device__ __forceinline__ Fe<N> mont_mul_nc(const Field<N>& f,
                                             const Fe<N>& a, Word b_word) {
  Fe<N> t = fe_zero<N>();
#ifdef FP_CIOS_ROLLED
#pragma unroll 1
#else
#pragma unroll
#endif
  for (int i = 0; i < N; ++i) {
    const uint32_t bi = b_word(i);
    uint64_t s = (uint64_t)a.w[0] * bi + t.w[0];
    uint32_t A = (uint32_t)(s >> 32);
    const uint32_t m = (uint32_t)s * f.np;
    uint64_t r = (uint64_t)m * f.q[0] + (uint32_t)s;
    uint32_t C = (uint32_t)(r >> 32);
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)a.w[j] * bi + t.w[j] + A;
      A = (uint32_t)(s >> 32);
      r = (uint64_t)m * f.q[j] + (uint32_t)s + C;
      C = (uint32_t)(r >> 32);
      t.w[j - 1] = (uint32_t)r;
    }
    t.w[N - 1] = C + A;
  }
  return cond_sub_q(f, t);
}

// a * k for a small k >= 0 by double-and-add.
template <int N>
__device__ __forceinline__ Fe<N> mul_small(const Field<N>& f, Fe<N> a, int k) {
  Fe<N> r = fe_zero<N>();
  for (; k; k >>= 1) {
    if (k & 1) r = add(f, r, a);
    if (k > 1) a = add(f, a, a);
  }
  return r;
}

// Component c of a stacked [k, L, n] operand (the tower and Miller-step
// kernels): lane i of limb plane j of component c sits at
// p[(c * L + j) * n + i].
template <int N>
__device__ __forceinline__ Fe<N> ld(const uint32_t* __restrict__ p, int c,
                                    int64_t n, int64_t i) {
  return load_fe<N>(p + (int64_t)c * 2 * N * n, n, i);
}

template <int N>
__device__ __forceinline__ void st(uint32_t* __restrict__ p, int c, int64_t n,
                                   int64_t i, const Fe<N>& a) {
  store_fe<N>(p + (int64_t)c * 2 * N * n, n, i, a);
}

// Grid-stride lane loop used by every kernel.
#define LANE_LOOP(i, n)                                                    \
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
       i += (int64_t)gridDim.x * blockDim.x)

// The launch of the one-thread-a-lane kernels: blocks of kThreads threads,
// one lane each, as many blocks as the lanes need (capped; the lane loop
// covers the rest).  That suits a batch that fills the card, but it puts a
// small one on a few SMs: 255 lanes are one block on one of the H100's 132
// SMs, whose loads, stores and integer pipes then set the pace of the
// whole launch.  So the field kernels K1 and K2 take spread_threads(n)
// threads a block instead: the fewest whole warps that cover n lanes in at
// most kSMs blocks, at most kThreads.  255 lanes run as 8 one-warp blocks
// on 8 SMs, 6,120 lanes as 96 blocks of 64, and from kSMs * kThreads =
// 33,792 lanes on this is grid_for's shape again.  K4 keeps grid_for's
// shape: its path launches it on 2^21 lanes and more.
constexpr int kThreads = 256;
constexpr int kSMs = 132;                       // H100 SXM
constexpr int kWarp = 32;

inline unsigned grid_for(int64_t n, int threads = kThreads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)blocks;
}

inline int spread_threads(int64_t n) {
  int64_t warps = (n + (int64_t)kSMs * kWarp - 1) /
                  ((int64_t)kSMs * kWarp);
  if (warps < 1) warps = 1;
  if (warps > kThreads / kWarp) warps = kThreads / kWarp;
  return (int)warps * kWarp;
}
