// K1: segment-sum of sorted (row, F-vector) updates, for sm_90a.
//
// Replaces: hashnerf_tpu/kernels/pallas_segment_accum.py,
//   segment_accumulate_sorted (pl.pallas_call, body _kernel): the scatter-add
//   of the hash-table gradients, reached through the hash-encode backward and
//   through take_rows in the TV loss.
//
// Computes out[r, :] = sum over j with sidx[j] == r of svals[j, :], for sidx
// sorted ascending (int32) and svals (M, F) float32; out is (num_rows, F).
//
// What bounds it on the H100: bytes. Each element is read once (4 B of index
// and 4F B of value) and each output row written once; at the chair fine
// backward (M = 25.2M, F = 2, 8.4M rows) that is about 369 MB, 0.11 ms at
// 3.35 TB/s. The arithmetic (M*F adds) is negligible.
//
// Design:
//  * Ownership, as in the TPU kernel: block w owns the aligned window of R
//    output rows [w*R, (w+1)*R). Windows are disjoint, so no two blocks write
//    one row and there are no global atomics. The block writes its whole
//    window once, zeros included, so `out` needs no prior memset.
//  * Range lookup: the TPU kernel took the window bounds by scalar prefetch;
//    here two threads of the block binary-search sidx for
//    lower_bound(w*R) and lower_bound((w+1)*R) themselves.
//  * Accumulation: the block walks its element range in coalesced chunks of
//    blockDim elements, sums runs of equal keys inside each warp with a
//    segmented shuffle scan (keys are sorted, so runs are contiguous), and the
//    last lane of each run adds the run's sum into the window's R*F floats in
//    shared memory. A hot row costs one shared atomic per warp per chunk
//    instead of one per element. Accumulation is float32.
//  * R is picked by the wrapper so that R*F*4 bytes is 16 KB.
//  * A run into one hot row (or a skewed window) serialises on one block:
//    correct, but slow.
//  * Element offsets are int64.
//  * The order of the additions differs from index_add_'s and between runs
//    (shared atomics from several warps): results agree up to float32
//    summation order.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t lower_bound_i32(const int* a, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(a[mid]) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_accumulate_sorted_kernel(const int* __restrict__ sidx,
                                 const float* __restrict__ svals,
                                 float* __restrict__ out,
                                 int64_t M, int F, int64_t num_rows, int R) {
  extern __shared__ float acc[];  // R * F window accumulator
  __shared__ int64_t range[2];

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  if (threadIdx.x < 2) {
    range[threadIdx.x] = lower_bound_i32(sidx, M, row0 + threadIdx.x * static_cast<int64_t>(R));
  }
  for (int i = threadIdx.x; i < R * F; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int64_t start = range[0];
  const int64_t end = range[1];
  const int lane = threadIdx.x & 31;

  // Every thread runs the same number of iterations (start/end are
  // block-uniform), so full-mask shuffles are safe.
  for (int64_t base = start; base < end; base += blockDim.x) {
    const int64_t j = base + threadIdx.x;
    const bool valid = j < end;
    // window-local row; INT_MAX past the end keeps the keys sorted
    const int key = valid ? static_cast<int>(static_cast<int64_t>(sidx[j]) - row0) : INT_MAX;

    bool same[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int off = 1 << s;
      const int k2 = __shfl_up_sync(0xffffffffu, key, off);
      same[s] = lane >= off && k2 == key;
    }
    const int knext = __shfl_down_sync(0xffffffffu, key, 1);
    const bool tail = valid && (lane == 31 || knext != key);

    for (int f = 0; f < F; ++f) {
      float v = valid ? svals[j * F + f] : 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const float o = __shfl_up_sync(0xffffffffu, v, 1 << s);
        if (same[s]) v += o;
      }
      if (tail) atomicAdd(&acc[key * F + f], v);
    }
  }
  __syncthreads();

  const int64_t rows = (num_rows - row0) < R ? (num_rows - row0) : R;
  float* dst = out + row0 * F;
  for (int64_t i = threadIdx.x; i < rows * F; i += blockDim.x) dst[i] = acc[i];
}

}  // namespace

extern "C" int segment_accumulate_sorted(const void* sidx, const void* svals, void* out,
                                         long long M, int F, long long num_rows, int R,
                                         void* stream) {
  if (num_rows <= 0) return 0;
  const long long blocks = (num_rows + R - 1) / R;
  const size_t smem = static_cast<size_t>(R) * F * sizeof(float);
  segment_accumulate_sorted_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sidx), static_cast<const float*>(svals),
      static_cast<float*>(out), M, F, num_rows, R);
  return static_cast<int>(cudaGetLastError());
}
