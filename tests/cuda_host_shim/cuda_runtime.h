// Host stand-in for the CUDA runtime, for tests/test_torch_csrc_host.py:
// with it g++ compiles the port's kernel sources (their <<<...>>> launch
// configurations removed) into host libraries whose kernels run serially,
// one "thread" walking every lane through the grid-stride loop.  The
// kernels use one thread per lane, no shared memory and no warp
// primitives, so this runs the same arithmetic as the card.
#pragma once
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(x)
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct HostDim3 {
  unsigned x, y, z;
};
static const HostDim3 blockIdx = {0, 0, 0}, threadIdx = {0, 0, 0},
                      blockDim = {1, 1, 1}, gridDim = {1, 1, 1};
