// K1-K4: the field kernels of the Groth16 prove path, for Hopper (sm_90a).
//
// K1 mont_mul   replaces wasmsnark_tpu/ops/fp_pallas.py _mont_mul_kernel
//               (mont_mul_pallas): batched CIOS x*y*R^-1 mod q.
// K2 mod_add/sub replaces fp_pallas.py _mod_addsub_kernel
//               (mod_add_pallas / mod_sub_pallas): (x +/- y) mod q.
// K3 butterfly  replaces fp_pallas.py _butterfly_kernel (butterfly_pallas):
//               one radix-2 NTT stage, (u + v*w, u - v*w) mod r.
// K4 cneg       replaces fp_pallas.py _cneg_kernel (mod_cneg_pallas):
//               flag ? q - y : y with -0 = 0.
//
// What bounds them on the H100: K2 and K4 move 8-12 bytes per limb-word
// and do a few integer ops, so they are bound by device-memory bytes.  K1
// and K3 do N^2 = 64 wide multiply-adds per product (~2N^2 + O(N) IMAD
// instructions) against 3 planes of 64 bytes each, so at one lane per
// thread they sit near the integer-issue limit, not the byte limit.
//
// Design: one thread per lane, the element held in registers as N 32-bit
// words, a grid-stride loop over lanes; K1 and K2 in blocks sized by
// fp.cuh's spread_threads, so that the few hundred lanes the pairing paths
// launch them with run on many SMs and not on one.  K1 at 24 words
// (MNT6753) has a second design for such batches, up to kK1TeamMaxLanes
// lanes: one lane's product spread over a team of 24 threads (below).
//
// Every entry point has a plain C interface for ctypes: device pointers
// and the CUDA stream as void*, the field constants as a host array of
// 3N+1 words (q, one, np, then -q^-1 mod 2^(32N), which only K1's team
// product reads), and it returns cudaGetLastError().
//
// The library is built per word count (fp.cuh, WORDS): N = 8 serves BN128
// Fp and Fr and BLS12-381 Fr, N = 12 BLS12-381 Fq, N = 24 MNT6753 Fq.  K3
// runs over Fr only, whose curves so far all have N = 8, so the other
// builds have no K3: its entry point there returns cudaErrorInvalidValue.

#include "team.cuh"

namespace {

template <int N>
__global__ void mont_mul_kernel(Field<N> f, const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ y,
                                uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    store_fe(out, n, i, mont_mul(f, load_fe<N>(x, n, i), load_fe<N>(y, n, i)));
  }
}

template <int N, bool kSub>
__global__ void addsub_kernel(Field<N> f, const uint32_t* __restrict__ x,
                              const uint32_t* __restrict__ y,
                              uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    Fe<N> a = load_fe<N>(x, n, i);
    Fe<N> b = load_fe<N>(y, n, i);
    store_fe(out, n, i, kSub ? sub(f, a, b) : add(f, a, b));
  }
}

#if WORDS == 24
// K1's team product at 24 words.
//
// One 24-word CIOS product on one thread is a chain of 24 x 48 dependent
// multiply-adds (~5 us on a lone warp), and the MNT6753 verify batch
// launches K1 mostly on 255-1,020 lanes, too few for other lanes to hide
// that chain.  So one lane's product is spread over a team of kN threads,
// in the full-width Montgomery form that the plain mont_mul_plain
// computes, R = 2^(32N):
//
//   T = x y,   m = (T mod R) (-q^-1 mod R) mod R,   U = T + m q,
//
// and U / R reduced by conditional subtracts of q.  Each product is a set
// of columns, sums of 32x32-bit products with no carry chain between
// them: thread k of a lane sums columns k and k + N of x y (and of m q, on
// top of T's), N products each, or column k of m.  A
// column is < 2^70: three words (lo, the 64-bit sum of the products' high
// halves).  Word k of a number given by its columns is nearly its
// column's low word plus the middle word of column k - 1 and the high
// word of column k - 2: that sum u_k < 2^34, and v_k = lo(u_k) + (u_{k-1}
// >> 32) <= 2^32 + 1 leaves at most a one-bit carry out of each word.
// Such 33-bit words still multiply into 64 bits, so m and m q are taken
// from the v words of T and of m's columns directly, read on the fly: the
// m so formed is m or m + R, and U / R < 3q.  Only U's words need exact
// carries: they follow from the words' generate and propagate flags by one
// 64-bit add (carry-in = ((G | P) + G) ^ (G | P) ^ G), which every thread
// forms from its lane's flag bytes; the subtracts of q and 2q are the
// same lookahead over borrows.
//
// A block serves kK1Lanes lanes, kN threads each; the values live in
// shared memory word-major (word k of lane g at [k * G + g], the Slots
// layout of team.cuh without its pad word), and the seven stages are
// team.cuh's team_for loops between __syncthreads(): no warp primitives,
// so tests/cuda_host_shim runs them one after the other.
constexpr int kK1Lanes = 4;     // lanes a block: 96 threads, three warps
// Above kK1TeamMaxLanes lanes K1 @N24 runs the one-thread kernel: with
// every SM busy, a team does more work per lane (three products, a
// normalization) than one thread's CIOS and finishes fewer lanes per
// SM-second.  The crossover was measured on the H100 (PERF.md §6);
// chip_cios_unroll.py builds variants with other values.
#ifndef K1_TEAM_MAX_LANES
#define K1_TEAM_MAX_LANES 2048
#endif
constexpr long long kK1TeamMaxLanes = K1_TEAM_MAX_LANES;

// -q^-1 mod 2^(32N), words 2N+1 .. 3N of the field constants.
template <int N>
struct WideInv {
  uint32_t w[N];
};

template <int N>
inline WideInv<N> wide_inv_from_words(const uint32_t* words) {
  WideInv<N> v;
  for (int k = 0; k < N; ++k) v.w[k] = words[2 * N + 1 + k];
  return v;
}

// A column: lo + hi 2^32, hi the sum of the products' high halves.
struct Col {
  uint32_t lo;
  uint64_t hi;
};

template <int N, int G>
struct WideSmem {
  uint32_t q[N], q2[N], inv[N];   // q, 2q and -q^-1 mod R
  uint32_t a[N * G];              // x, then U / R
  uint32_t b[N * G];              // y
  uint32_t c[3][2 * N * G];       // columns of x y, then of U (three words)
  uint32_t mc[3][N * G];          // columns of m
  uint32_t v[2 * N * G];          // U's words before their carries
  uint32_t flag[G * N / 2];       // per lane 2N flag bytes of those words
  uint32_t sflag[2][G * N / 4];   // per lane N flag bytes of U/R - q, - 2q
};

template <int G>
__device__ __forceinline__ void put_col(uint32_t* const* c, int k, int g,
                                        const Col& col) {
  c[0][k * G + g] = col.lo;
  c[1][k * G + g] = (uint32_t)col.hi;
  c[2][k * G + g] = (uint32_t)(col.hi >> 32);
}

// c0_k + c1_{k-1} + c2_{k-2} of the column planes c: < 2^34.
template <int G>
__device__ __forceinline__ uint64_t col_sum(const uint32_t* const* c, int k,
                                            int g) {
  uint64_t s = c[0][k * G + g];
  if (k >= 1) s += c[1][(k - 1) * G + g];
  if (k >= 2) s += c[2][(k - 2) * G + g];
  return s;
}

// The words v_0, v_1, ... of the number with column planes c, in order,
// each <= 2^32 + 1: v_k = lo(u_k) + (u_{k-1} >> 32).
template <int G>
struct VWords {
  const uint32_t* const* c;
  int g;
  uint64_t below = 0;                       // u_{k-1}
  __device__ __forceinline__ uint64_t next(int k) {
    const uint64_t u = col_sum<G>(c, k, g);
    const uint64_t v = (u & 0xFFFFFFFFu) + (below >> 32);
    below = u;
    return v;
  }
};

// The words of a number held word-major in shared memory, in order.
template <int G>
struct SmemWords {
  const uint32_t* a;
  int g;
  __device__ __forceinline__ uint64_t next(int i) const { return a[i * G + g]; }
};

// col += v w for a word v <= 2^32 + 1 and w < 2^32: the low word of v
// takes one wide multiply-add, its bit 32 adds w to the high half.
__device__ __forceinline__ void mul_add(Col& col, uint64_t v, uint32_t w) {
  const uint64_t p = (uint64_t)(uint32_t)v * w + col.lo;
  col.lo = (uint32_t)p;
  col.hi += (p >> 32) + ((v >> 32) ? w : 0);
}

// Columns k and k + N of v w, v's words from vw.next(i), w's word j from
// ww(j), added to lo and hi and stored to the planes c: product i goes to
// column k while i <= k, to column k + N after, chosen without a branch.
template <int N, int G, class VW, class WWord>
__device__ __forceinline__ void two_columns(uint32_t* const* c, VW vw,
                                            WWord ww, int k, int g, Col lo,
                                            Col hi) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool low = i <= k;
    const uint64_t v = vw.next(i);
    const uint32_t w = ww(low ? k - i : k + N - i);
    Col cur{low ? lo.lo : hi.lo, 0};
    mul_add(cur, v, w);
    lo.lo = low ? cur.lo : lo.lo;
    hi.lo = low ? hi.lo : cur.lo;
    lo.hi += low ? cur.hi : 0;
    hi.hi += low ? 0 : cur.hi;
  }
  put_col<G>(c, k, g, lo);
  put_col<G>(c, k + N, g, hi);
}

// Word k of a number's normalization before its one-bit carry, into v,
// and its flag byte: bit 0 it carries out (generate), bit 1 it passes a
// carry on (propagate: all ones).
__device__ __forceinline__ uint8_t gen_prop(uint64_t v) {
  return (uint8_t)((v >> 32) | (uint32_t)((uint32_t)v == 0xFFFFFFFFu) << 1);
}

// Bit 0 of each of the four bytes of x, in order.
__device__ __forceinline__ uint32_t gather4(uint32_t x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// The carries into words 0..W-1 (bit k; bit W the carry out) from W flag
// bytes, four to a 32-bit word.
template <int W>
__device__ __forceinline__ uint64_t carries(const uint32_t* flags) {
  uint64_t gen = 0, prop = 0;
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    gen |= (uint64_t)gather4(flags[i]) << (4 * i);
    prop |= (uint64_t)gather4(flags[i] >> 1) << (4 * i);
  }
  const uint64_t a = gen | prop;
  return (a + gen) ^ a ^ gen;
}

// The borrow flag byte of h - s for words h and s.
__device__ __forceinline__ uint8_t borrow_flag(uint32_t h, uint32_t s) {
  return (uint8_t)((uint32_t)(h < s) | (uint32_t)(h == s) << 1);
}

// Word k of H - 2q, H - q or H, the one in [0, q), for H < 3q with word
// h, given the borrows b1 of H - q and b2 of H - 2q (carries<N> of their
// flag bytes: bit k the borrow into word k, bit N the borrow out).
template <int N>
__device__ __forceinline__ uint32_t reduce_3q(uint32_t h, uint32_t qk,
                                              uint32_t q2k, uint64_t b1,
                                              uint64_t b2, int k) {
  const bool ge2 = !((b2 >> N) & 1), ge1 = !((b1 >> N) & 1);
  return ge2 ? h - q2k - (uint32_t)((b2 >> k) & 1)
       : ge1 ? h - qk - (uint32_t)((b1 >> k) & 1) : h;
}

template <int N, int G>
__global__ void __launch_bounds__(N * G)
mont_mul_team_kernel(Field<N> f, WideInv<N> inv,
                     const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ y,
                     uint32_t* __restrict__ out, int64_t n) {
  static_assert(N % 4 == 0 && 2 * N <= 63, "flag bytes and carry masks");
  __shared__ WideSmem<N, G> s;
  uint32_t* const cp[3] = {s.c[0], s.c[1], s.c[2]};
  uint32_t* const mp[3] = {s.mc[0], s.mc[1], s.mc[2]};
  uint8_t* const flag8 = reinterpret_cast<uint8_t*>(s.flag);
  if (threadIdx.x == 0) {
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s.q[k] = f.q[k];
      s.q2[k] = f.q[k] << 1 | carry;
      carry = f.q[k] >> 31;
      s.inv[k] = inv.w[k];
    }
  }
  for (int64_t base = (int64_t)blockIdx.x * G; base < n;
       base += (int64_t)gridDim.x * G) {
    team_for<G>(2 * N, base, n, [&](int it, int g) {   // x's and y's words
      const int k = it < N ? it : it - N;
      const uint32_t* p = it < N ? x : y;
      const int64_t i = base + g;
      (it < N ? s.a : s.b)[k * G + g] =
          (p[2 * k * n + i] & 0xFFFFu) | (p[(2 * k + 1) * n + i] << 16);
    });
    __syncthreads();
    team_for<G>(N, base, n, [&](int k, int g) {        // T = x y
      two_columns<N, G>(cp, SmemWords<G>{s.a, g},
                        [&](int j) { return s.b[j * G + g]; }, k, g,
                        Col{0, 0}, Col{0, 0});
    });
    __syncthreads();
    team_for<G>(N, base, n, [&](int k, int g) {        // m's columns
      VWords<G> tw{cp, g};
      Col col{0, 0};
#pragma unroll
      for (int i = 0; i < N; ++i)
        mul_add(col, tw.next(i), i <= k ? s.inv[k - i] : 0);
      put_col<G>(mp, k, g, col);
    });
    __syncthreads();
    team_for<G>(N, base, n, [&](int k, int g) {        // U = T + m q
      const Col lo{s.c[0][k * G + g],
                   s.c[1][k * G + g] | (uint64_t)s.c[2][k * G + g] << 32};
      const Col hi{s.c[0][(k + N) * G + g],
                   s.c[1][(k + N) * G + g]
                       | (uint64_t)s.c[2][(k + N) * G + g] << 32};
      two_columns<N, G>(cp, VWords<G>{mp, g}, [&](int j) { return s.q[j]; },
                        k, g, lo, hi);
    });
    __syncthreads();
    team_for<G>(N, base, n, [&](int k, int g) {        // U's words, flags
#pragma unroll
      for (int w = k; w < 2 * N; w += N) {
        const uint64_t v = (col_sum<G>(cp, w, g) & 0xFFFFFFFFu)
            + (w >= 1 ? col_sum<G>(cp, w - 1, g) >> 32 : 0);
        s.v[w * G + g] = (uint32_t)v;
        flag8[g * 2 * N + w] = gen_prop(v);
      }
    });
    __syncthreads();
    team_for<G>(N, base, n, [&](int k, int g) {        // H = U / R < 3q
      const uint64_t cy = carries<2 * N>(s.flag + g * N / 2);
      const uint32_t h = s.v[(k + N) * G + g]
          + (uint32_t)((cy >> (k + N)) & 1);
      s.a[k * G + g] = h;
      reinterpret_cast<uint8_t*>(s.sflag[0])[g * N + k] =
          borrow_flag(h, s.q[k]);
      reinterpret_cast<uint8_t*>(s.sflag[1])[g * N + k] =
          borrow_flag(h, s.q2[k]);
    });
    __syncthreads();
    team_for<G>(N, base, n, [&](int k, int g) {        // H, H - q or H - 2q
      const uint64_t b1 = carries<N>(s.sflag[0] + g * N / 4);
      const uint64_t b2 = carries<N>(s.sflag[1] + g * N / 4);
      const uint32_t r = reduce_3q<N>(s.a[k * G + g], s.q[k], s.q2[k], b1, b2,
                                      k);
      const int64_t i = base + g;
      out[2 * k * n + i] = r & 0xFFFFu;
      out[(2 * k + 1) * n + i] = r >> 16;
    });
    __syncthreads();
  }
}

#endif

#if WORDS == 8
// One NTT stage over the whole domain.  x and out are [L, n] planes; the
// stage pairs lane u = g*2h + j with v = u + h (h = half the group size)
// and multiplies v by twiddle j of the [L, h] table tw.
template <int N>
__global__ void butterfly_kernel(Field<N> f, const uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ tw,
                                 uint32_t* __restrict__ out, int64_t n,
                                 int64_t h) {
  LANE_LOOP(t, n / 2) {
    int64_t g = t / h, j = t - g * h;
    int64_t iu = g * 2 * h + j, iv = iu + h;
    Fe<N> u = load_fe<N>(x, n, iu);
    Fe<N> v = mont_mul(f, load_fe<N>(x, n, iv), load_fe<N>(tw, h, j));
    store_fe(out, n, iu, add(f, u, v));
    store_fe(out, n, iv, sub(f, u, v));
  }
}
#endif

template <int N>
__global__ void cneg_kernel(Field<N> f, const uint8_t* __restrict__ flag,
                            const uint32_t* __restrict__ y,
                            uint32_t* __restrict__ out, int64_t n) {
  LANE_LOOP(i, n) {
    store_fe(out, n, i, cneg(f, flag[i] != 0, load_fe<N>(y, n, i)));
  }
}

}  // namespace

extern "C" {

int k1_mont_mul(const void* x, const void* y, void* out, long long n,
                int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
#if WORDS == 24
  if (n <= kK1TeamMaxLanes) {
    mont_mul_team_kernel<kN, kK1Lanes>
        <<<team_grid(n, kK1Lanes), kN * kK1Lanes, 0, (cudaStream_t)stream>>>(
            f, wide_inv_from_words<kN>((const uint32_t*)consts),
            (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
    return (int)cudaGetLastError();
  }
#endif
  const int threads = spread_threads(n);
  mont_mul_kernel<kN><<<grid_for(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k2_mod_add(const void* x, const void* y, void* out, long long n,
               int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  const int threads = spread_threads(n);
  addsub_kernel<kN, false><<<grid_for(n, threads), threads, 0,
                            (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k2_mod_sub(const void* x, const void* y, void* out, long long n,
               int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  const int threads = spread_threads(n);
  addsub_kernel<kN, true><<<grid_for(n, threads), threads, 0,
                            (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k3_butterfly(const void* x, const void* tw, void* out, long long n,
                 long long h, int n_limbs, const void* consts, void* stream) {
#if WORDS == 8
  if (bad_args(n_limbs, n) || h < 1 || n % (2 * h) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  butterfly_kernel<kN><<<grid_for(n / 2), kThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)out, n, h);
  return (int)cudaGetLastError();
#else
  return (int)cudaErrorInvalidValue;
#endif
}

int k4_cneg(const void* flag, const void* y, void* out, long long n,
            int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  cneg_kernel<kN><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint8_t*)flag, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
