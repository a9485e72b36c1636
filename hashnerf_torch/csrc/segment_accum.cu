// K1 and K4: segment-sum of sorted (row, F-vector) updates, for sm_90a. K1
// (below) takes narrow rows, F <= 64; K4 (further down) takes rows up to 256
// floats wide. kernels/segment_accum.py routes by F.
//
// Replaces: hashnerf_tpu/kernels/pallas_segment_accum.py,
//   segment_accumulate_sorted (pl.pallas_call, body _kernel), with its sorted
//   contract. The training paths reach the scatter-add of the hash-table
//   gradients through K5 (scatter_add.cu), which needs no sort.
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

// K4: the same contract for wide rows (F up to 256), as the packed layout
// gathers them: 8F = 64 floats a dense-level voxel row, 27F = 216 floats a
// fine-level slab at F = 8 (hashnerf_tpu/ops/packed_grid.py:221,241 and the
// packed TV, train/losses.py:148,178; the TPU wrapper pads F to a multiple of
// 8 and runs the same Pallas kernel).
//
// What bounds it: bytes again. At the flagship fine shape (M = 393,216
// slabs, F = 216, 131,072 rows) it reads 340 MB of values and 1.6 MB of ids
// and writes a 113 MB table: 0.136 ms at 3.35 TB/s.
//
// Design (K1 has each lane walk its own row F times, strided; here):
//  * Lanes own features, not elements: lane l holds features l, l+32, ...,
//    so a warp reads one row of F floats as one coalesced access.
//  * Ownership as in K1: block w owns the aligned window of R rows, finds its
//    element range by two binary searches, accumulates in R*F floats of
//    shared memory and writes the whole window once. No global atomics, no
//    memset. The wrapper sets R in rows, not bytes: ids with a few hot rows
//    (the dense levels) want short windows, so that the hot rows spread over
//    more blocks. Above 48 KB of window the kernel asks for the larger
//    dynamic shared memory.
//  * Each of the 8 warps walks one contiguous eighth of the block's element
//    range. Runs of equal ids are summed in registers and a run costs one
//    shared atomic per feature when it ends, so a hot row costs one atomic
//    per feature per warp, not one per element. A hot row still serialises
//    on one block, as in K1.
//  * Loads are issued kUnroll rows ahead of the adds, so each warp keeps
//    kUnroll * ceil(F/32) loads in flight.
//  * The order of the additions varies with the warp split (shared atomics):
//    results agree with index_add_ up to float32 summation order.

constexpr int kWideThreads = 256;
constexpr int kUnroll = 4;

template <int NK>
__device__ __forceinline__ void flush_run(float* acc, int key, int F, int lane, const float (&run)[NK]) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int f = lane + 32 * k;
    if (f < F) atomicAdd(&acc[key * F + f], run[k]);
  }
}

template <int NK>
__global__ void __launch_bounds__(kWideThreads)
segment_accumulate_wide_kernel(const int* __restrict__ sidx,
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

  // this warp's contiguous share of the block's elements
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t n = range[1] - range[0];
  const int64_t per = (n + nwarps - 1) / nwarps;
  const int64_t lo = range[0] + (per * warp < n ? per * warp : n);
  const int64_t hi = range[0] + (per * (warp + 1) < n ? per * (warp + 1) : n);

  float run[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) run[k] = 0.f;
  int cur = -1;  // window-local row of the open run

  // cnt, e and every key are warp-uniform, so the shuffles and branches are too
  for (int64_t base = lo; base < hi; base += 32) {
    const int cnt = (hi - base) < 32 ? static_cast<int>(hi - base) : 32;
    const int mykey = lane < cnt ? static_cast<int>(static_cast<int64_t>(sidx[base + lane]) - row0) : -1;
    for (int e = 0; e < cnt; e += kUnroll) {
      float v[kUnroll][NK];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* row = svals + (base + e + u) * F;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int f = lane + 32 * k;
          v[u][k] = (e + u < cnt && f < F) ? __ldg(row + f) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = __shfl_sync(0xffffffffu, mykey, (e + u) & 31);
        if (e + u >= cnt) break;
        if (key != cur) {
          if (cur >= 0) flush_run<NK>(acc, cur, F, lane, run);
          cur = key;
#pragma unroll
          for (int k = 0; k < NK; ++k) run[k] = v[u][k];
        } else {
#pragma unroll
          for (int k = 0; k < NK; ++k) run[k] += v[u][k];
        }
      }
    }
  }
  if (cur >= 0) flush_run<NK>(acc, cur, F, lane, run);
  __syncthreads();

  const int64_t rows = (num_rows - row0) < R ? (num_rows - row0) : R;
  float* dst = out + row0 * F;
  for (int64_t i = threadIdx.x; i < rows * F; i += blockDim.x) dst[i] = acc[i];
}

template <int NK>
int launch_wide(const int* sidx, const float* svals, float* out, long long M, int F,
                long long num_rows, int R, cudaStream_t stream) {
  const long long blocks = (num_rows + R - 1) / R;
  const size_t smem = static_cast<size_t>(R) * F * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_accumulate_wide_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_accumulate_wide_kernel<NK><<<static_cast<unsigned>(blocks), kWideThreads, smem, stream>>>(
      sidx, svals, out, M, F, num_rows, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_accumulate_k1(const void* sidx, const void* svals, void* out,
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

extern "C" int segment_accumulate_k4(const void* sidx, const void* svals, void* out,
                                     long long M, int F, long long num_rows, int R,
                                     void* stream) {
  if (num_rows <= 0) return 0;
  const int* i = static_cast<const int*>(sidx);
  const float* v = static_cast<const float*>(svals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((F + 31) / 32) {
    case 1: return launch_wide<1>(i, v, o, M, F, num_rows, R, s);
    case 2: return launch_wide<2>(i, v, o, M, F, num_rows, R, s);
    case 3: return launch_wide<3>(i, v, o, M, F, num_rows, R, s);
    case 4: return launch_wide<4>(i, v, o, M, F, num_rows, R, s);
    case 5: return launch_wide<5>(i, v, o, M, F, num_rows, R, s);
    case 6: return launch_wide<6>(i, v, o, M, F, num_rows, R, s);
    case 7: return launch_wide<7>(i, v, o, M, F, num_rows, R, s);
    case 8: return launch_wide<8>(i, v, o, M, F, num_rows, R, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
