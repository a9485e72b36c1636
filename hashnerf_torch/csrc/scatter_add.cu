// K5: sort-free scatter-add of (row, F-vector) updates, for sm_90a.
//
// Replaces: hashnerf_tpu/kernels/pallas_segment_accum.py:93-140,
//   segment_accumulate_sorted (pl.pallas_call at :134), as the JAX package
//   reaches it through kernels/segment_scatter.py::sorted_segment_accumulate
//   (:43-59): the scatter-add of the hash-table gradients behind the hash
//   encode's backward and every take_rows. On those paths K5 takes the place
//   of torch.sort + K1 / K4 (segment_accum.cu), which stay for the sorted
//   contract.
//
// Computes out[r, :] += vals[j, :] for every j with 0 <= idx[j] < num_rows,
// for ids in any order (int32 or int64), vals (M, F) float32 with
// 1 <= F <= 256, and out (num_rows, F) float32, zeroed by the wrapper. An id
// outside [0, num_rows) is dropped, as XLA's scatter drops it: an atomic
// kernel without that check would write out of bounds.
//
// What bounds it on the H100: the bytes (ids and values read once, the table
// written once: 302 MB + 67 MB at the chair encode backward, 0.11 ms at
// 3.35 TB/s), and the L2's throughput for reductions to global memory, which
// Hopper performs in the L2 itself, up to 16 bytes an instruction. The sort
// that K1 and K4 need costs more than either kernel on this card.
//
// Design:
//  * No sort and no ownership: each update is added to its row with vector
//    reductions (atomicAdd on float2 / float4, compiled to RED when the result
//    is unused). The order of the additions changes from run to run, so
//    results agree with index_add_ up to float32 summation order.
//  * Values and ids are read once, with streaming loads (__ldcs), so that they
//    do not push the table's lines out of the L2.
//  * Narrow rows, F <= 8 (the chair table, F = 2; the packed TV cubes, F = 8):
//    one lane takes one update. __match_any_sync groups the lanes of a warp
//    that hold the same row; each group sums its values by shuffles in
//    log2(group size) rounds, and its first lane issues one reduction (two
//    at F = 8). K3 emits updates in (level, point, corner) order, so at the
//    coarse levels neighbouring samples of a ray share vertices: the grouping
//    cuts the reductions where rows are hot.
//  * Wide rows, F > 8 (64-float voxel rows, 216-float slabs): a group of G
//    lanes (a power of two: the fewest that give each lane one vector of the
//    row, up to 32) takes a row; lane l holds vectors l, l + G,
//    ..., as K4 reads a row, so the group reads and adds a row with
//    coalesced 16-byte accesses (54 reductions a row at 216 floats). Each
//    group walks a contiguous chunk of updates and keeps runs of equal ids
//    in registers, adding a run when it ends: the dense levels list
//    neighbouring samples of a ray one after the other. The next kUnroll
//    updates are loaded before their adds.
//  * A row that is not a multiple of 4 (or 2) floats wide is not 16-byte
//    (8-byte) aligned, and takes float2 (scalar) accesses instead.
//  * A grid-stride loop over at most kBlocksPerSM blocks of kThreads an SM.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kUnroll = 4;
constexpr int kMaxF = 256;

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VW == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int VW>
__device__ __forceinline__ void red_vec(float* p, const float* v) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VW == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// the row of update j, or -1 where it is dropped
template <typename Idx>
__device__ __forceinline__ Idx row_of(const Idx* idx, int64_t j, int64_t num_rows) {
  const Idx r = __ldcs(idx + j);
  return (r >= 0 && static_cast<int64_t>(r) < num_rows) ? r : Idx(-1);
}

template <typename Idx, int F>
__global__ void __launch_bounds__(kThreads)
scatter_narrow_kernel(const Idx* __restrict__ idx, const float* __restrict__ vals,
                      float* __restrict__ out, int64_t M, int64_t num_rows) {
  constexpr int VW = F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // base is warp-uniform, so all 32 lanes run every iteration together and
  // the full-mask votes and shuffles below are safe
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < M; base += stride) {
    const int64_t j = base + lane;
    const Idx key = j < M ? row_of(idx, j, num_rows) : Idx(-1);
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.f;
    if (key >= 0) {
#pragma unroll
      for (int f = 0; f < F; f += VW) load_vec<VW>(vals + j * F + f, v + f);
    }

    // Lanes of one row (dropped lanes, key -1, form one group too). A tree
    // sum: in each round every lane still in its group adds the value of the
    // next lane still in it, then the lanes of odd rank leave. The first lane
    // ends with the group's sum.
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    unsigned rest = peers & ~below & ~(1u << lane);  // the group's lanes above this one
    unsigned rank = __popc(peers & below);
    while (__any_sync(0xffffffffu, rest != 0)) {
      const int next = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float o = __shfl_sync(0xffffffffu, v[f], next);
        if (next != lane) v[f] += o;
      }
      rest &= ~__ballot_sync(0xffffffffu, rank & 1u);
      rank >>= 1;
    }
    if (key >= 0 && (peers & below) == 0) {
      float* dst = out + static_cast<int64_t>(key) * F;
#pragma unroll
      for (int f = 0; f < F; f += VW) red_vec<VW>(dst + f, v + f);
    }
  }
}

template <typename Idx, int VW>
__global__ void __launch_bounds__(kThreads)
scatter_wide_kernel(const Idx* __restrict__ idx, const float* __restrict__ vals,
                    float* __restrict__ out, int64_t M, int F, int64_t num_rows,
                    int G, int chunk) {
  constexpr int NK = kMaxF / 32 / VW;  // vectors a lane holds at most
  const int nv = F / VW;                // vectors a row
  const int sub = threadIdx.x & (G - 1);
  const int64_t group = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t ngroups = static_cast<int64_t>(gridDim.x) * blockDim.x / G;
  const int64_t nchunks = (M + chunk - 1) / chunk;

  // Every lane of a group sees the same ids, so a group's branches are
  // uniform; groups of one warp may diverge (no warp-wide operation here).
  for (int64_t c = group; c < nchunks; c += ngroups) {
    const int64_t lo = c * chunk;
    const int64_t hi = (lo + chunk) < M ? (lo + chunk) : M;
    float run[NK][VW] = {};
    Idx cur = -1;  // row of the open run; a run of dropped ids is never added

    for (int64_t e = lo; e < hi; e += kUnroll) {
      Idx r[kUnroll];
      float v[kUnroll][NK][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = e + u;
        r[u] = j < hi ? row_of(idx, j, num_rows) : Idx(-1);
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int vi = sub + k * G;
          if (r[u] >= 0 && vi < nv) {
            load_vec<VW>(vals + j * F + vi * VW, v[u][k]);
          } else {
#pragma unroll
            for (int w = 0; w < VW; ++w) v[u][k][w] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e + u >= hi) break;
        if (r[u] != cur) {
          if (cur >= 0) {
#pragma unroll
            for (int k = 0; k < NK; ++k) {
              const int vi = sub + k * G;
              if (vi < nv) red_vec<VW>(out + static_cast<int64_t>(cur) * F + vi * VW, run[k]);
            }
          }
          cur = r[u];
#pragma unroll
          for (int k = 0; k < NK; ++k)
#pragma unroll
            for (int w = 0; w < VW; ++w) run[k][w] = v[u][k][w];
        } else {
#pragma unroll
          for (int k = 0; k < NK; ++k)
#pragma unroll
            for (int w = 0; w < VW; ++w) run[k][w] += v[u][k][w];
        }
      }
    }
    if (cur >= 0) {
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int vi = sub + k * G;
        if (vi < nv) red_vec<VW>(out + static_cast<int64_t>(cur) * F + vi * VW, run[k]);
      }
    }
  }
}

// blocks of the grid-stride loops: kBlocksPerSM on every SM of the current device
cudaError_t max_blocks(int* cap) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *cap = sms * kBlocksPerSM;
  return err == cudaSuccess && sms <= 0 ? cudaErrorInvalidDevice : err;
}

unsigned grid_for(long long threads, int cap) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

template <typename Idx, int F>
int launch_narrow(const void* idx, const float* vals, float* out, long long M,
                  long long num_rows, int cap, cudaStream_t s) {
  scatter_narrow_kernel<Idx, F><<<grid_for(M, cap), kThreads, 0, s>>>(
      static_cast<const Idx*>(idx), vals, out, M, num_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int launch(const void* idx, const float* vals, float* out, long long M, int F,
           long long num_rows, int chunk, int cap, cudaStream_t s) {
  switch (F) {
    case 1: return launch_narrow<Idx, 1>(idx, vals, out, M, num_rows, cap, s);
    case 2: return launch_narrow<Idx, 2>(idx, vals, out, M, num_rows, cap, s);
    case 3: return launch_narrow<Idx, 3>(idx, vals, out, M, num_rows, cap, s);
    case 4: return launch_narrow<Idx, 4>(idx, vals, out, M, num_rows, cap, s);
    case 5: return launch_narrow<Idx, 5>(idx, vals, out, M, num_rows, cap, s);
    case 6: return launch_narrow<Idx, 6>(idx, vals, out, M, num_rows, cap, s);
    case 7: return launch_narrow<Idx, 7>(idx, vals, out, M, num_rows, cap, s);
    case 8: return launch_narrow<Idx, 8>(idx, vals, out, M, num_rows, cap, s);
    default: break;
  }
  const int vw = F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);
  int G = 1;
  while (G < 32 && G * vw < F) G *= 2;  // one vector a lane, up to 32 lanes
  const long long threads = (M + chunk - 1) / chunk * G;
  const unsigned grid = grid_for(threads, cap);
  const Idx* i = static_cast<const Idx*>(idx);
  if (vw == 4) {
    scatter_wide_kernel<Idx, 4><<<grid, kThreads, 0, s>>>(i, vals, out, M, F, num_rows, G, chunk);
  } else if (vw == 2) {
    scatter_wide_kernel<Idx, 2><<<grid, kThreads, 0, s>>>(i, vals, out, M, F, num_rows, G, chunk);
  } else {
    scatter_wide_kernel<Idx, 1><<<grid, kThreads, 0, s>>>(i, vals, out, M, F, num_rows, G, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// idx_bytes is 4 (int32 ids) or 8 (int64); chunk is the number of updates a
// wide-row group walks (unused for F <= 8). Returns a cudaError_t.
extern "C" int segment_accumulate_k5(const void* idx, int idx_bytes, const void* vals,
                                     void* out, long long M, int F, long long num_rows,
                                     int chunk, void* stream) {
  if (F < 1 || F > kMaxF || chunk < 1 || (idx_bytes != 4 && idx_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M <= 0 || num_rows <= 0) return 0;
  int cap = 0;
  const cudaError_t err = max_blocks(&cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx_bytes == 4 ? launch<int>(idx, v, o, M, F, num_rows, chunk, cap, s)
                        : launch<long long>(idx, v, o, M, F, num_rows, chunk, cap, s);
}
