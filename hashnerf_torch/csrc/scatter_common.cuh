// Device code shared by K5 (scatter_add.cu) and K6 (hash_encode.cu): vector
// loads, vector reductions into a float32 table, and the warp's grouping of
// the lanes that add to one row.
//
// A reduction is atomicAdd on float / float2 / float4 with its result
// unused, which Hopper compiles to RED and performs in the L2 itself, up to
// 16 bytes an instruction. Rows that many lanes of a warp hit at once (the
// coarse levels of a hash grid, where neighbouring samples of a ray share
// vertices) are summed in registers first, so such a row takes one
// reduction a warp instead of one a lane.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace scatter {

// Streaming loads (__ldcs): values read once should not push the table's
// lines out of the L2.
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

// Widest vector that divides a row of F floats (4, 2 or 1).
template <int F>
__host__ __device__ constexpr int vec_width() {
  return F % 4 == 0 ? 4 : (F % 2 == 0 ? 2 : 1);
}

// Adds v to row `key` of out (rows `stride` floats apart, the row aligned to
// its vector width) for each lane whose key is >= 0; a lane with key -1 adds
// nothing. __match_any_sync groups the lanes of the warp that hold the same
// key (dropped lanes form one group too). A tree sum: in each round every
// lane still in its group adds the value of the next lane still in it, then
// the lanes of odd rank leave, so a group of k lanes takes log2(k) rounds.
// The group's first lane ends with the sum and issues the reductions.
//
// Every lane of the warp must call this together: the votes and shuffles
// use the full mask. A caller with nothing to add passes key -1; it never
// returns early.
template <int F, typename Key>
__device__ __forceinline__ void warp_group_add(Key key, float (&v)[F], float* __restrict__ out,
                                               int64_t stride) {
  constexpr int VW = vec_width<F>();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // lanes under this one
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
    float* dst = out + static_cast<int64_t>(key) * stride;
#pragma unroll
    for (int f = 0; f < F; f += VW) red_vec<VW>(dst + f, v + f);
  }
}

}  // namespace scatter
