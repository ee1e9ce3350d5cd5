// Host stand-in for the CUDA runtime, for tests/test_torch_csrc_host.py:
// with it g++ compiles the port's kernel sources (their <<<...>>> launch
// configurations removed) into host libraries whose kernels run serially
// on one "thread" of a block and grid of size 1.  A one-thread-per-lane
// kernel walks every lane through its grid-stride loop; a team kernel
// (csrc/team.cuh) walks every group of lanes and, inside a group, every
// item of each stage in turn, so its __syncthreads() are no-ops and its
// __shared__ slots are one static array.  No kernel uses warp primitives,
// so this runs the same arithmetic as the card.
#pragma once
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __constant__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline void __syncthreads() {}
struct HostDim3 {
  unsigned x, y, z;
};
static const HostDim3 blockIdx = {0, 0, 0}, threadIdx = {0, 0, 0},
                      blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
