// Device code shared by K5 (scatter_add.cu), K6 (hash_encode.cu) and K8
// (packed_encode.cu): vector loads, vector reductions into a float32 table,
// and two ways to sum, before they add, the lanes of a warp that add to one
// row.
//
// A reduction is atomicAdd on float / float2 / float4 with its result
// unused, which Hopper compiles to RED and performs in the L2 itself, up to
// 16 bytes an instruction. Rows that many lanes of a warp hit at once (the
// coarse levels of a hash grid, where neighbouring samples of a ray share
// vertices) are summed in registers first, so such a row takes one
// reduction a warp instead of one a lane.
//
// The groupings (every lane of the warp must call one together: their
// votes and shuffles use the full mask; a lane with nothing to add passes
// key -1 and never returns early):
//  * warp_group_add: __match_any_sync finds the lanes that hold one key,
//    wherever they are in the warp. It costs a match and a vote even where
//    every key is distinct.
//  * warp_run_add: only runs of one key in neighbouring lanes are summed:
//    one shuffle and one ballot find the runs' heads, and a warp with no run
//    longer than one lane stops there. Along a ray the lanes that share a
//    row are neighbours; a repeat that is not a neighbour adds on its own,
//    which gives the same sum up to float32 summation order. K6 takes it at
//    the hashed levels, where nearly every key of a warp is distinct.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace scatter {

constexpr unsigned kFullMask = 0xffffffffu;

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

// True if any of the F floats is not +-0 (a NaN counts as not zero).
template <int F>
__device__ __forceinline__ bool any_nonzero(const float* v) {
  bool nz = false;
#pragma unroll
  for (int f = 0; f < F; ++f) nz = nz || v[f] != 0.f;
  return nz;
}

// Adds v to row `key` of out (rows `stride` floats apart, the row aligned to
// its vector width) for each lane whose key is >= 0; a lane with key -1 adds
// nothing. __match_any_sync groups the lanes of the warp that hold the same
// key (dropped lanes form one group too). A tree sum: in each round every
// lane still in its group adds the value of the next lane still in it, then
// the lanes of odd rank leave, so a group of k lanes takes log2(k) rounds.
// The group's first lane ends with the sum and issues the reductions.
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

// The same for runs of one key in neighbouring lanes: a lane whose key
// differs from lane - 1's heads a run, which ends under the next head; a
// dropped lane (key -1) is a run of its own, so lanes with nothing to add
// never make the warp sum. A segmented suffix sum (Hillis-Steele: in the
// round of distance d every lane adds the value d lanes up if that lane is
// in its run) leaves each head with its run's sum; the rounds stop at the
// longest run, at most 5. Each head with a key >= 0 issues the reductions.
template <int F, typename Key>
__device__ __forceinline__ void warp_run_add(Key key, float (&v)[F], float* __restrict__ out,
                                             int64_t stride) {
  const int lane = threadIdx.x & 31;
  const Key prev = __shfl_up_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != key || key < 0);
  if (heads != kFullMask) {  // some run is longer than one lane (warp-uniform)
    const unsigned above = heads & ~((2u << lane) - 1u);  // heads above this lane
    const int end = above ? __ffs(above) - 1 : 32;         // this run's end
    int longest = 0;  // the longest stretch of lanes that head no run
    for (unsigned t = ~heads; t; t &= t >> 1) ++longest;
    for (int d = 1; d <= longest; d <<= 1) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float o = __shfl_down_sync(kFullMask, v[f], d);
        if (lane + d < end) v[f] += o;
      }
    }
  }
  if (key >= 0 && ((heads >> lane) & 1u)) {
    constexpr int VW = vec_width<F>();
    float* dst = out + static_cast<int64_t>(key) * stride;
#pragma unroll
    for (int f = 0; f < F; f += VW) red_vec<VW>(dst + f, v + f);
  }
}

}  // namespace scatter
