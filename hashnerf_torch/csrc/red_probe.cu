// A probe of the card's rate for vector reductions into global memory, for
// sm_90a: no kernel of the port and on no path. chip_diag.py encode-bwd
// times it as the reduction bound of K6 and K8 (a scatter design that issues
// that many reductions cannot take less), beside their byte bound.
//
// red_probe adds VW floats (VW = 1, 2 or 4; atomicAdd with its result
// unused, compiled to RED and performed in the L2) `count` times into a
// table of `rows` rows of VW floats, rows a power of two. Update i goes to
// row hash(i) & (rows - 1) when `scattered` is set (the lanes of a warp hit
// distinct random rows, as K6's do at the hashed levels), else to row
// i & (rows - 1) (a warp's 32 updates fill whole sectors). A grid-stride
// loop over 8 blocks of 256 threads an SM.

#include <cuda_runtime.h>
#include <cstdint>

#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t mix(uint64_t z) {  // splitmix64's finaliser
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

template <int VW>
__global__ void __launch_bounds__(kThreads)
red_probe_kernel(float* __restrict__ table, uint64_t row_mask, int64_t count, int scattered) {
  float v[VW];
#pragma unroll
  for (int f = 0; f < VW; ++f) v[f] = 1.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const uint64_t r = (scattered ? mix(static_cast<uint64_t>(i)) : static_cast<uint64_t>(i)) &
                       row_mask;
    scatter::red_vec<VW>(table + r * VW, v);
  }
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for a VW other than 1, 2 or
// 4, or rows not a power of two. sms is the card's SM count.
extern "C" int red_probe(void* table, long long rows, long long count, int vw, int scattered,
                         int sms, void* stream) {
  if (rows < 1 || (rows & (rows - 1)) || count < 0 || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(table);
  const uint64_t mask = static_cast<uint64_t>(rows - 1);
  const unsigned blocks = static_cast<unsigned>(sms) * 8u;
  switch (vw) {
    case 1: red_probe_kernel<1><<<blocks, kThreads, 0, s>>>(t, mask, count, scattered); break;
    case 2: red_probe_kernel<2><<<blocks, kThreads, 0, s>>>(t, mask, count, scattered); break;
    case 4: red_probe_kernel<4><<<blocks, kThreads, 0, s>>>(t, mask, count, scattered); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
