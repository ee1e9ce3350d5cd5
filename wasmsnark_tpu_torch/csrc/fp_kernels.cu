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
// Design now: one thread per lane, the element held in registers as N
// 32-bit words, a grid-stride loop over lanes.  Simple and right first;
// multi-lane-per-thread and wide-multiply tricks are later work.
//
// Every entry point has a plain C interface for ctypes: device pointers
// and the CUDA stream as void*, the field constants as a host array of
// 2N+1 words (q, one, np), and it returns cudaGetLastError().
//
// The library is built per word count (fp.cuh, WORDS): N = 8 serves BN128
// Fp and Fr and BLS12-381 Fr, N = 12 BLS12-381 Fq.  K3 runs over Fr only,
// whose curves so far all have N = 8, so the N = 12 build has no K3: its
// entry point there returns cudaErrorInvalidValue.

#include "fp.cuh"

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
  mont_mul_kernel<kN><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k2_mod_add(const void* x, const void* y, void* out, long long n,
               int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  addsub_kernel<kN, false><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      f, (const uint32_t*)x, (const uint32_t*)y, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int k2_mod_sub(const void* x, const void* y, void* out, long long n,
               int n_limbs, const void* consts, void* stream) {
  if (bad_args(n_limbs, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Field<kN> f = field_from_words<kN>((const uint32_t*)consts);
  addsub_kernel<kN, true><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
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
