// A team of threads per lane: the machinery of the tower kernels that
// spread one lane's base-field products over several threads.
//
// A block serves G lanes at a time.  Their values live in shared memory as
// slots, one field element of one lane each, and a kernel is a static
// schedule of stages over the slots, separated by __syncthreads():
//
//  - a product stage runs a table of base products, each "(sum of up to
//    four slots) x (sum of up to four slots) -> slot", one per thread: the
//    thread forms both sums itself with fp.cuh's `add`, keeps the first in
//    registers with the CIOS accumulator, parks the second in its output
//    slot and streams that slot's words into the CIOS loop (fp.cuh's
//    no-carry `mont_mul_nc`);
//  - a combine stage gives each thread one output coefficient of adds,
//    subs and small multiples, written to a slot or to device memory.
//
// Every value stays canonical (< q), so the order of evaluation cannot
// change a result: the kernels stay bit-identical to their plain versions.
//
// The stage loops are `for (w = threadIdx.x; w < G * items; w +=
// blockDim.x)` with item w / G of lane w % G, and lanes >= n skip their work
// but still reach every __syncthreads(): so any block shape computes every
// item, and the host build of tests/cuda_host_shim (one thread, block and
// grid of size 1) runs each stage serially in the same order.  No warp
// primitives.  The items of a warp that take different branches run one
// branch after the other, so combine bodies are written branch-free where
// they can be, and loops with other bodies start on warps of their own.

#pragma once

#include "fp.cuh"

constexpr uint8_t kNoSlot = 0xFF;

// One base product of a product stage: the sum of the slots a times the
// sum of the slots b, into slot out (kNoSlot ends a list).
struct Prod {
  uint8_t a[4], b[4], out;
};

// Table lines of a product stage, three slots to an F3 value.
//
// The six base products v0, v1, v2, t01, t12, t02 of the Karatsuba F3
// product (towers.py F3Device.mul) of the values at slots a.. and b.., into
// slots o..o+5.
#define F3_PRODS(a, b, o)                                                    \
  {{a, kNoSlot, kNoSlot, kNoSlot}, {b, kNoSlot, kNoSlot, kNoSlot}, o},       \
  {{a + 1, kNoSlot, kNoSlot, kNoSlot},                                       \
   {b + 1, kNoSlot, kNoSlot, kNoSlot}, o + 1},                               \
  {{a + 2, kNoSlot, kNoSlot, kNoSlot},                                       \
   {b + 2, kNoSlot, kNoSlot, kNoSlot}, o + 2},                               \
  {{a, a + 1, kNoSlot, kNoSlot}, {b, b + 1, kNoSlot, kNoSlot}, o + 3},       \
  {{a + 1, a + 2, kNoSlot, kNoSlot}, {b + 1, b + 2, kNoSlot, kNoSlot},       \
   o + 4},                                                                   \
  {{a, a + 2, kNoSlot, kNoSlot}, {b, b + 2, kNoSlot, kNoSlot}, o + 5}
// The same for (A + A2)(B + B2), the F3 sums taken inside the products.
#define F3_PRODS_SUM(a, a2, b, b2, o)                                        \
  {{a, a2, kNoSlot, kNoSlot}, {b, b2, kNoSlot, kNoSlot}, o},                 \
  {{a + 1, a2 + 1, kNoSlot, kNoSlot}, {b + 1, b2 + 1, kNoSlot, kNoSlot},     \
   o + 1},                                                                   \
  {{a + 2, a2 + 2, kNoSlot, kNoSlot}, {b + 2, b2 + 2, kNoSlot, kNoSlot},     \
   o + 2},                                                                   \
  {{a, a + 1, a2, a2 + 1}, {b, b + 1, b2, b2 + 1}, o + 3},                   \
  {{a + 1, a + 2, a2 + 1, a2 + 2}, {b + 1, b + 2, b2 + 1, b2 + 2}, o + 4},   \
  {{a, a + 2, a2, a2 + 2}, {b, b + 2, b2, b2 + 2}, o + 5}
// The F3 value at slots a.. times the base element at slot s, into o..o+2.
#define F3_SCAL(a, s, o)                                                     \
  {{a, kNoSlot, kNoSlot, kNoSlot}, {s, kNoSlot, kNoSlot, kNoSlot}, o},       \
  {{a + 1, kNoSlot, kNoSlot, kNoSlot}, {s, kNoSlot, kNoSlot, kNoSlot},       \
   o + 1},                                                                   \
  {{a + 2, kNoSlot, kNoSlot, kNoSlot}, {s, kNoSlot, kNoSlot, kNoSlot}, o + 2}

// Coefficient k of a Karatsuba product over a cubic extension (towers.py
// F3Device.mul, build_f3m.js) from its six products v0, v1, v2, t01, t12,
// t02 (indices 0-5): c_k = (A - B - C) + m (D - E - F) with m the
// non-residue for k = 0, 1 and 1 for k = 2, and
//   k = 0: v0 - 0 - 0 + m (t12 - v1 - v2),
//   k = 1: t01 - v0 - v1 + m (v2 - 0 - 0),
//   k = 2: t02 - v0 - v2 + (v1 - 0 - 0),
// the indices of A..F per k, -1 for zero: one straight-line body for every
// k, so that the items of a warp, which take different k, do not diverge.
__constant__ int8_t kCoefSlots[3][6] = {
    {0, -1, -1, 4, 1, 2}, {3, 0, 1, 2, -1, -1}, {5, 0, 2, 1, -1, -1}};

// The slots of one block: word k of slot s of lane g at
// p[(s * (N + 1) + k) * G + g].  Word-major, so the G lanes of one item
// read neighbouring banks; the pad word shifts consecutive slots by G banks,
// so the items that share a warp mostly read other banks too.
template <int N, int G>
struct Slots {
  static constexpr int kStride = (N + 1) * G;   // words per slot
  uint32_t* p;

  __device__ __forceinline__ uint32_t* word0(int s, int g) const {
    return p + s * kStride + g;                 // word k at [k * G]
  }
  __device__ __forceinline__ Fe<N> get(int s, int g) const {
    const uint32_t* q = word0(s, g);
    Fe<N> a;
#pragma unroll
    for (int k = 0; k < N; ++k) a.w[k] = q[k * G];
    return a;
  }
  // slot s, or zero where keep is false, without a branch
  __device__ __forceinline__ Fe<N> get_if(int s, bool keep, int g) const {
    Fe<N> a = get(s, g);
    const uint32_t mask = keep ? ~0u : 0u;
#pragma unroll
    for (int k = 0; k < N; ++k) a.w[k] &= mask;
    return a;
  }
  __device__ __forceinline__ void put(int s, int g, const Fe<N>& a) const {
    uint32_t* q = word0(s, g);
#pragma unroll
    for (int k = 0; k < N; ++k) q[k * G] = a.w[k];
  }
  // the sum of up to four slots
  __device__ __forceinline__ Fe<N> sum(const Field<N>& f, const uint8_t* s,
                                       int g) const {
    Fe<N> a = get(s[0], g);
#pragma unroll
    for (int r = 1; r < 4; ++r)
      if (s[r] != kNoSlot) a = add(f, a, get(s[r], g));
    return a;
  }
};

// The items of one stage: body(item, g) for every item < items of every
// lane g < G of the block's group at lane `base`, lanes >= n skipped,
// from thread `first` on: two loops of one stage with other bodies can
// start on warps of their own, so that no warp runs both.
template <int G, class Body>
__device__ __forceinline__ void team_for(int items, int64_t base, int64_t n,
                                         Body body, int first = 0) {
  for (int w = (int)threadIdx.x - first; w < G * items; w += blockDim.x) {
    const int g = w % G;
    if (w >= 0 && base + g < n) body(w / G, g);
  }
}

// The first thread of a loop that is to start on a warp of its own after a
// loop of `items` items a lane (team_for's `first`).
__host__ __device__ constexpr int warp_after(int items, int G) {
  return (items * G + kWarp - 1) / kWarp * kWarp;
}

// A product stage: the `items` base products of table tbl.
template <int N, int G>
__device__ __forceinline__ void prod_stage(const Field<N>& f,
                                           const Slots<N, G>& s,
                                           const Prod* tbl, int items,
                                           int64_t base, int64_t n) {
  team_for<G>(items, base, n, [&](int it, int g) {
    const Prod pr = tbl[it];
    s.put(pr.out, g, s.sum(f, pr.b, g));
    const Fe<N> a = s.sum(f, pr.a, g);
    const uint32_t* b = s.word0(pr.out, g);
    s.put(pr.out, g, mont_mul_nc<N>(f, a, [&](int i) { return b[i * G]; }));
  });
}

// The grid of a team kernel: one block per group of G lanes, capped; the
// group loop of the kernel covers the rest.
inline unsigned team_grid(long long n, int G) {
  long long blocks = (n + G - 1) / G;
  if (blocks < 1) blocks = 1;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)blocks;
}
