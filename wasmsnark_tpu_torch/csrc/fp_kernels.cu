// K1-K4: the field kernels of the Groth16 prove path, for Hopper (sm_90a).
//
// K1 mont_mul   replaces wasmsnark_tpu/ops/fp_pallas.py _mont_mul_kernel
//               (mont_mul_pallas): batched CIOS x*y*R^-1 mod q.
// K2 mod_add/sub replaces fp_pallas.py _mod_addsub_kernel
//               (mod_add_pallas / mod_sub_pallas): (x +/- y) mod q.
// K3 ntt_pass   replaces fp_pallas.py _butterfly_kernel (butterfly_pallas):
//               radix-2 NTT stages, (u + v*w, u - v*w) mod r, up to ten a
//               launch in shared memory (below); butterfly, one stage.
// K4 cneg       replaces fp_pallas.py _cneg_kernel (mod_cneg_pallas):
//               flag ? q - y : y with -0 = 0.
//
// What bounds them on the H100: K2 and K4 move 8-12 bytes per limb-word
// and do a few integer ops, so they are bound by device-memory bytes.  K1
// and K3 do N^2 = 64 wide multiply-adds per product (~2N^2 + O(N) IMAD
// instructions) against 3 planes of 64 bytes each, so at one lane per
// thread they sit near the integer-issue limit, not the byte limit.
//
// Design (K1, K2, K4): one thread per lane, the element held in
// registers as N 32-bit words, a grid-stride loop over lanes; K1 and K2 in
// blocks sized by fp.cuh's spread_threads, so that the few hundred lanes
// the pairing paths launch them with run on many SMs and not on one.  K1 at 24 words
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
// K3: radix-2 NTT stages in shared memory.
//
// The TPU kernel runs one stage a call, (u + v w, u - v w) over the whole
// domain; run that way on the card, a 2^16 transform is 16 launches that
// each read and write the whole 4 MB of planes again, plus a bit-reverse
// gather before them and, for an inverse, a mirror gather and a 1/N
// product after.  Here one launch, a pass, runs stages [s0, s1) of the
// bit-reversed-input DIT on tiles held in shared memory.  Stage s (from 0)
// pairs element u with u + 2^s, so stages s0..s1-1 combine only elements
// that agree on every index bit outside [s0, s1): a tile fixes those bits
// and takes all 2^(s1-s0) rows of the bits inside, for C consecutive low
// indices (its columns), and for G whole groups where one group's columns
// leave room.  Pass 1 (s0 = 0, C = 1) takes runs of 2^k consecutive
// elements; a later pass takes C >= 4 columns, runs of at least 16 bytes
// of each limb plane, and consecutive threads take consecutive columns.
// A tile holds up to kNttTile elements (32 KB of static shared memory, so
// at most 10 stages a pass); the caller picks a smaller tile where the
// domain would otherwise leave SMs idle (ops/ntt.py ntt_passes: 512
// elements and two passes at 2^16, 1,024 and two at 2^17, three passes
// at 2^21).
//
// The ends of a transform ride on its passes: pass 1 loads element i from
// x[rev(i)] (the bit-reverse gather), and an inverse's last pass stores
// element i at (n - i) mod n times 1/N (the mirror and the scale).
// Twiddles come from one table per transform, stage s's 2^s entries at
// column 2^s - 1 of [L, n - 1] planes (ops/ntt.py NTTDevice.plan); a pass
// reads its stages' entries through L1 and L2.
//
// What bounds it: per butterfly one 8-word Montgomery product (~2N^2 wide
// multiply-adds) and an add and a sub, against 64 bytes of planes read and
// written once a pass, so the SM's integer multiply-add pipe: a stage
// costs what one tile's butterflies cost its SM, about the same with 8 or
// 16 warps a block (PERF.md §6).  Every value stays canonical, so any
// split into passes gives the plain version's planes bit for bit.  In
// shared memory an element is 8 words of 32 bits, word-major (word w of
// element e at s[w * kNttTile + e]), so the threads of a warp read
// neighbouring banks.
//
// K3's one-stage entry point k3_butterfly runs the same kernel over one
// stage of any width h dividing n/2, with the [L, h] table of that stage.
//
// The loops over a tile are `for (w = threadIdx.x; ...; w += blockDim.x)`
// with a __syncthreads() after each that every thread reaches, and no warp
// primitives: tests/cuda_host_shim runs the same code on one thread.
constexpr int kNttTileLog = 10;
constexpr int kNttTile = 1 << kNttTileLog;       // elements a tile at most
constexpr int kNttThreads = kNttTile / 2;        // a butterfly a thread

// The geometry of one pass over [L, n] planes: the stages of half-width
// H, 2H, ..., 2^(k-1) H, a tile of 2^logG groups x 2^k rows x 2^logC
// columns; element (g, r, c) of tile t is element ((g0 + g) 2^k + r) H + l0
// + c of the domain, g0 = (t / chunks) 2^logG, l0 = (t % chunks) 2^logC.
struct NttPass {
  int64_t n;          // elements of the domain
  int64_t H;          // half-width of the pass's first stage: the columns
  int64_t groups;     // n / (2^k H): runs that the pass combines within
  int64_t chunks;     // tiles across one group's columns, ceil(H / 2^logC)
  int64_t tiles;
  int64_t tw_stride;  // elements in a plane of the twiddle table
  int64_t tw_bias;    // twiddle j of the stage of half-width hs at hs - bias + j
  int k, logC, logG;
  int rev_bits;       // > 0: element i loads from x[rev(i)] over rev_bits bits
  int mirror;         // element i stores at (n - i) mod n, times scale
};

// The low `bits` bits of v in reverse order (bits <= 32); the shim has no
// __brev, so the swaps are written out.
__host__ __device__ inline uint32_t reverse_bits(uint32_t v, int bits) {
  v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
  v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
  v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
  v = ((v >> 8) & 0x00FF00FFu) | ((v & 0x00FF00FFu) << 8);
  v = (v >> 16) | (v << 16);
  return bits ? v >> (32 - bits) : 0;
}

template <int N>
__global__ void __launch_bounds__(kNttThreads)
ntt_pass_kernel(Field<N> f, const uint32_t* x, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ scale, uint32_t* out, NttPass p) {
  // x and out may be one buffer (a pass without gather or mirror reads and
  // writes the same elements of a tile): no __restrict__ on them
  __shared__ uint32_t s[N * kNttTile];
  const int R = 1 << p.k, C = 1 << p.logC;
  const int elems = R << (p.logC + p.logG);
  const Fe<N> invn = p.mirror ? load_fe<N>(scale, 1, 0) : fe_zero<N>();
  for (int64_t t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int64_t g0 = (t / p.chunks) << p.logG;
    const int64_t l0 = (t % p.chunks) << p.logC;
    // element e of the tile in the domain, or -1 past a group's columns or
    // past the last group
    auto index = [&](int e) -> int64_t {
      const int64_t g = g0 + (e >> (p.k + p.logC)), l = l0 + (e & (C - 1));
      if (g >= p.groups || l >= p.H) return -1;
      return (g * R + ((e >> p.logC) & (R - 1))) * p.H + l;
    };
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int64_t i = index(e);
      if (i < 0) continue;
      const int64_t src = p.rev_bits ? reverse_bits((uint32_t)i, p.rev_bits)
                                     : i;
#pragma unroll
      for (int w = 0; w < N; ++w)
        s[w * kNttTile + e] = (x[2 * w * p.n + src] & 0xFFFFu)
                              | (x[(2 * w + 1) * p.n + src] << 16);
    }
    __syncthreads();
    for (int st = 0; st < p.k; ++st) {
      const int low = (1 << st) - 1;
      for (int b = threadIdx.x; b < elems / 2; b += blockDim.x) {
        // butterfly b: column c, rows r and r + 2^st of group g
        const int c = b & (C - 1), rest = b >> p.logC;
        const int rr = rest & (R / 2 - 1), g = rest >> (p.k - 1);
        const int r = (rr & ~low) << 1 | (rr & low);
        const int eu = ((g << p.k | r) << p.logC) | c;
        const int ev = eu + (C << st);
        if (index(eu) < 0) continue;
        const int64_t j = (int64_t)(r & low) * p.H + l0 + c;
        const Fe<N> w = load_fe<N>(tw, p.tw_stride,
                                   (p.H << st) - p.tw_bias + j);
        Fe<N> u, v;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          u.w[k] = s[k * kNttTile + eu];
          v.w[k] = s[k * kNttTile + ev];
        }
        const Fe<N> vw = mont_mul(f, v, w);
        const Fe<N> sum = add(f, u, vw), dif = sub(f, u, vw);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          s[k * kNttTile + eu] = sum.w[k];
          s[k * kNttTile + ev] = dif.w[k];
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int64_t i = index(e);
      if (i < 0) continue;
      Fe<N> a;
#pragma unroll
      for (int w = 0; w < N; ++w) a.w[w] = s[w * kNttTile + e];
      if (p.mirror) a = mont_mul(f, a, invn);
      store_fe(out, p.n, p.mirror ? (p.n - i) & (p.n - 1) : i, a);
    }
    __syncthreads();
  }
}

// Fills p for the stages of half-width H .. 2^(k-1) H over n elements
// on tiles of up to 2^tile_log elements (2^k H divides n, k <= tile_log
// <= kNttTileLog): as many columns as fit, up to H, and then as many
// groups as fit, up to all of them.  Returns the threads a block.
inline int ntt_geometry(NttPass& p, int64_t n, int64_t H, int k,
                        int tile_log) {
  const int tile = 1 << tile_log;
  p.n = n;
  p.H = H;
  p.k = k;
  p.groups = n / (H << k);
  p.logC = 0;
  while ((2LL << p.logC) <= H && (2 << (p.logC + k)) <= tile) ++p.logC;
  p.chunks = (H + (1LL << p.logC) - 1) >> p.logC;
  p.logG = 0;
  if (p.chunks == 1)
    while ((1LL << p.logG) < p.groups
           && (2 << (p.logG + p.logC + k)) <= tile)
      ++p.logG;
  p.tiles = ((p.groups + (1LL << p.logG) - 1) >> p.logG) * p.chunks;
  const int half = (1 << (k + p.logC + p.logG)) / 2;
  const int threads = (half + kWarp - 1) / kWarp * kWarp;
  return threads < kWarp ? kWarp : threads > kNttThreads ? kNttThreads
                                                          : threads;
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

#if WORDS == 8
// One pass of K3 with geometry p over a tile grid, on the stream.
static int ntt_launch(NttPass& p, int threads, const void* x, const void* tw,
                      const void* scale, void* out, const void* consts,
                      void* stream) {
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  const unsigned blocks = grid_for(p.tiles, 1);
  ntt_pass_kernel<kN><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)scale,
      (uint32_t*)out, p);
  return (int)cudaGetLastError();
}
#endif

// One stage: lane u = g*2h + j with u + h, twiddle j of the [L, h] table tw.
int k3_butterfly(const void* x, const void* tw, void* out, long long n,
                 long long h, int n_limbs, const void* consts, void* stream) {
#if WORDS == 8
  if (bad_args(n_limbs, n) || h < 1 || n % (2 * h) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  NttPass p;
  const int threads = ntt_geometry(p, n, h, 1, kNttTileLog);
  p.tw_stride = h;
  p.tw_bias = h;
  p.rev_bits = 0;
  p.mirror = 0;
  return ntt_launch(p, threads, x, tw, tw, out, consts, stream);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

// Stages [s0, s1) of a transform of n = 2^bits elements on tiles of up to
// 2^tile_log elements, twiddles from the transform's [L, n - 1] table tw;
// flags bit 0: load element i from x[rev(i)] first; bit 1: store element
// i at (n - i) mod n times the [L, 1] planes scale.  s1 - s0 <= tile_log
// <= kNttTileLog.
int k3_ntt_pass(const void* x, const void* tw, const void* scale, void* out,
                long long n, long long s0, long long s1, long long flags,
                long long tile_log, int n_limbs, const void* consts,
                void* stream) {
#if WORDS == 8
  if (bad_args(n_limbs, n) || (n & (n - 1)) != 0 || s0 < 0 || s1 < s0
      || tile_log > kNttTileLog || s1 - s0 > tile_log || flags < 0
      || flags > 3 || n > (1LL << 32))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int bits = 0;
  while ((1LL << bits) < n) ++bits;
  if (s1 > bits) return (int)cudaErrorInvalidValue;
  NttPass p;
  const int threads = ntt_geometry(p, n, 1LL << s0, (int)(s1 - s0),
                                   (int)tile_log);
  p.tw_stride = n - 1;
  p.tw_bias = 1;
  p.rev_bits = (flags & 1) ? bits : 0;
  p.mirror = (flags & 2) ? 1 : 0;
  return ntt_launch(p, threads, x, tw, scale, out, consts, stream);
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
