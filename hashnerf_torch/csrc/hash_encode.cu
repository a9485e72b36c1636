// K2, K3 and K6: the hash-grid encode forward and backward, for sm_90a.
//
// Replaces: hashnerf_tpu/kernels/hash_encode_vjp.py, hash_encode_fast.
//   K2 hash_encode_fwd        <- _fwd_impl (:63-74) with _corner_geometry (:33-54)
//   K6 hash_encode_bwd        <- _bwd_rule (:82-99): the geometry recomputed,
//                                cw * g for every corner, and the scatter-add
//                                into the (L*T, F) table gradient
//   K3 hash_encode_bwd_expand <- _bwd_rule's corner expansion alone (:82-92),
//                                whose scatter-add is K5 (scatter_add.cu). On
//                                no path since K6; kept as the route K6
//                                replaced and as the corner-id gate.
// These are XLA functions on the TPU, not Pallas kernels; they carry the work
// around the Pallas kernel on the main path.
//
// K2: one thread per (level, point). It clips the point to the bbox, computes
//   the voxel geometry, hashes the 8 corners in uint32, gathers the 8 rows of
//   table[l] and blends them with the trilinear weights into
//   feats[n, l*F:(l+1)*F]. keep[n] (inside the bbox before clipping) is
//   written once per point, by its level-0 thread.
// K6: one thread per (level, point). It reads g[n, l*F:(l+1)*F] once; a
//   lane whose row is all +-0 adds nothing, and a warp of such lanes
//   returns. The others recompute the geometry (only x and the bbox are
//   saved by the forward) and, for each corner c, add cw_c * g to
//   d_table[l*T + idx_c]: the lanes of a warp that hit one row are summed by
//   shuffles (scatter_common.cuh), and the sum goes to the L2 as one vector
//   reduction. No (id, value) pair reaches device memory.
// K3: one thread per (level, point); writes, for each corner c,
//   flat_idx[(l*N + n)*8 + c] = idx + l*T and vals[..., f] = cw * g[n, l*F+f]:
//   the (L, N, 8) layout the JAX backward hands to the segment-sum.
//
// What bounds them on the H100. K2: its bytes (x, the table rows it touches,
//   the features: 0.019 ms at the chair fine pass), but each corner is a
//   random 8-byte gather, one 32-byte sector request to the L2; a table of
//   67 MB does not fit the 50 MB L2, a group's slice does. K6: its bytes
//   (x, g and the table written once: 94.6 MB, 0.028 ms at the fine pass),
//   and in practice the L2's throughput for reductions, about 80 a ns into
//   a slice the L2 holds (csrc/red_probe.cu): 25.2M of them at the fine
//   pass on uniform points, fewer where a warp's lanes share rows or a
//   sample's cotangent is zero (outside the bbox, or sigma <= 0).
//   K3: the 302 MB of pairs it writes. Integer hashing and the blend are a
//   few hundred operations a point-level, far below the card's rate. The
//   times, on an NVIDIA H100 80GB HBM3 at 700 W, are in PERF.md.
//
// Design of K2 and K6:
//  * Level groups. The grid is ordered by groups of GL consecutive levels,
//    outermost (GL, a launch argument, 4 levels = 16.8 MB of a 2^19 x 2
//    table). The blocks in flight then gather from, or reduce into, one
//    group's table slice, which stays in the L2; the whole table does not.
//  * Inside a group, K2's lanes take the GL levels of one point, then the
//    next point (level-fastest: a warp reads x and writes feats in whole
//    sectors). K6's warps each take 32 points of one level, the next warps
//    the group's other levels of those points (point-fastest:
//    __match_any_sync sees 32 samples of one level, which along a ray share
//    rows at the coarse levels). Each order was the faster one for its
//    kernel on the card; PERF.md has the times.
//    Points are padded to a multiple of 32, so every warp is whole.
//  * Vector accesses for F = 2, 4, 8: a table row is one 8- or 16-byte load
//    (two at F = 8), g one vector a (point, level), a feature row one store.
//    Other F take a scalar path.
//  * K6's grouping, by level: where a level's (res+1)^3 vertices fit the
//    table, __match_any_sync finds every lane of the warp that shares a
//    row (along a ray, and at the bbox's faces); at a hashed level nearly
//    every lane's row is its own, and the cheaper run grouping (one
//    shuffle and one ballot) sums only neighbouring lanes. Skipping zero
//    rows is exact: the table starts at +0 and adding +-0 to a float32 sum
//    that started at +0 leaves it as it was.
//  * No shared-memory accumulation: summing the coarse levels' vertex
//    boxes in shared memory before one reduction a vertex was measured
//    slower (PERF.md): a float add into shared memory is a compare-and-swap
//    loop on this card, which hot rows serialise, where the L2 adds 8 or
//    16 bytes an instruction.
//
// Exactness: the geometry follows the JAX order
//   grid = (bmax-bmin)/res; rel = (xc-bmin)/grid; bl = floor(rel);
//   minv = bl*grid + bmin; w = (xc-minv)/grid
// with every operation rounded on its own (__f*_rn intrinsics, and the build
// passes --fmad=false and no fast math): an FMA or an approximate division can
// flip floor() at a cell boundary and select another hashed corner. K2, K3
// and K6 share these device functions, so they pick the same corners. K2
// blends the corners in the order c = 0..7, so its features do not depend
// on the layout.

#include <cuda_runtime.h>
#include <cstdint>

#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 805459861u;

struct Voxel {
  int bl[3];
  float w[3];
  bool inside;
};

__device__ __forceinline__ Voxel voxel_geometry(const float* __restrict__ x,
                                                const float* __restrict__ bmin,
                                                const float* __restrict__ bmax,
                                                float res) {
  Voxel v;
  v.inside = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float lo = bmin[d];
    const float hi = bmax[d];
    const float p = x[d];
    v.inside = v.inside && (p >= lo) && (p <= hi);
    const float xc = fminf(fmaxf(p, lo), hi);
    const float grid = __fdiv_rn(__fsub_rn(hi, lo), res);
    const float rel = __fdiv_rn(__fsub_rn(xc, lo), grid);
    const int b = static_cast<int>(floorf(rel));
    const float minv = __fadd_rn(__fmul_rn(static_cast<float>(b), grid), lo);
    v.bl[d] = b;
    v.w[d] = __fdiv_rn(__fsub_rn(xc, minv), grid);
  }
  return v;
}

// Corner c uses offsets (c>>2, (c>>1)&1, c&1), the BOX_OFFSETS bit order.
__device__ __forceinline__ uint32_t corner_index(const Voxel& v, int c, uint32_t mask) {
  const uint32_t cx = static_cast<uint32_t>(v.bl[0] + (c >> 2));
  const uint32_t cy = static_cast<uint32_t>(v.bl[1] + ((c >> 1) & 1));
  const uint32_t cz = static_cast<uint32_t>(v.bl[2] + (c & 1));
  return ((cx * 1u) ^ (cy * kP1) ^ (cz * kP2)) & mask;
}

__device__ __forceinline__ float corner_weight(const Voxel& v, int c) {
  const float wx = (c >> 2) ? v.w[0] : __fsub_rn(1.f, v.w[0]);
  const float wy = ((c >> 1) & 1) ? v.w[1] : __fsub_rn(1.f, v.w[1]);
  const float wz = (c & 1) ? v.w[2] : __fsub_rn(1.f, v.w[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The (point, level) of thread t in the level-group orders (see the notes at
// the top); Np is N rounded up to 32. n >= N or l >= L marks a padding lane.
struct Slot {
  int64_t n;
  int l;
};

// K2: the group's levels of one point, then the next point.
__device__ __forceinline__ Slot level_fastest_slot(int64_t t, int64_t Np, int GL) {
  const int64_t per_group = Np * GL;
  const int64_t grp = t / per_group;
  const int64_t i = t - grp * per_group;
  Slot s;
  s.n = i / GL;
  s.l = static_cast<int>(grp) * GL + static_cast<int>(i - s.n * GL);
  return s;
}

// K6: 32 points of one level a warp, the next warps the group's other levels.
__device__ __forceinline__ Slot point_fastest_slot(int64_t t, int64_t Np, int GL) {
  const int64_t per_group = Np * GL;
  const int64_t grp = t / per_group;
  const int64_t w = (t - grp * per_group) >> 5;  // the warp's rank in its group
  Slot s;
  s.n = (w / GL) * 32 + (t & 31);
  s.l = static_cast<int>(grp) * GL + static_cast<int>(w % GL);
  return s;
}

// Row loads through the read-only path: the table (K2) is read many times
// per row at the coarse levels, g (K6) GL times per sector point-fastest.
template <int F>
__device__ __forceinline__ void load_row(const float* p, float* v) {
  if constexpr (F == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + f));
      v[f] = t.x; v[f + 1] = t.y; v[f + 2] = t.z; v[f + 3] = t.w;
    }
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* p, const float* v) {
  if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int f = 0; f < F; f += 4) {
      *reinterpret_cast<float4*>(p + f) = make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]);
    }
  }
}

// FT is F for the vector paths (2, 4, 8) and 0 for the scalar path, which
// reads F from Fr.
template <int FT>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                       const float* __restrict__ bmin, const float* __restrict__ bmax,
                       const float* __restrict__ res, float* __restrict__ feats,
                       uint8_t* __restrict__ keep, int64_t N, int64_t Np, int64_t total,
                       int L, int log2T, int Fr, int GL) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const Slot s = level_fastest_slot(t, Np, GL);
  if (s.n >= N || s.l >= L) return;  // K2 has no warp-wide operation
  const int F = FT > 0 ? FT : Fr;

  const Voxel v = voxel_geometry(x + s.n * 3, bmin, bmax, res[s.l]);
  const uint32_t mask = (1u << log2T) - 1u;
  const float* tab = table + (static_cast<int64_t>(s.l) << log2T) * F;
  float* dst = feats + s.n * L * F + static_cast<int64_t>(s.l) * F;
  if constexpr (FT > 0) {
    float row[8][FT];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      load_row<FT>(tab + static_cast<int64_t>(corner_index(v, c, mask)) * FT, row[c]);
    }
    float acc[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = corner_weight(v, c);
#pragma unroll
      for (int f = 0; f < FT; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, row[c][f]));
    }
    store_row<FT>(dst, acc);
  } else {
    uint32_t idx[8];
    float cw[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      idx[c] = corner_index(v, c, mask);
      cw[c] = corner_weight(v, c);
    }
    for (int f = 0; f < F; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc = __fadd_rn(acc, __fmul_rn(cw[c], tab[static_cast<int64_t>(idx[c]) * F + f]));
      }
      dst[f] = acc;
    }
  }
  if (s.l == 0) keep[s.n] = v.inside ? 1 : 0;
}

template <int FT>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ x, const float* __restrict__ bmin,
                       const float* __restrict__ bmax, const float* __restrict__ res,
                       const float* __restrict__ g, float* __restrict__ d_table, int64_t N,
                       int64_t Np, int64_t total, int L, int log2T, int Fr, int GL) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // total is a multiple of 32 and blocks start at multiples of 32, so this
  // and the return below leave whole warps; a padding lane, or one whose
  // cotangent row is zero, stays with key -1 for the full-mask votes of
  // the grouping
  if (t >= total) return;
  const Slot s = point_fastest_slot(t, Np, GL);
  bool active = s.n < N && s.l < L;
  const int64_t n = active ? s.n : 0;
  const int l = active ? s.l : 0;
  const int F = FT > 0 ? FT : Fr;
  const float* gn = g + n * L * F + static_cast<int64_t>(l) * F;
  float gv[FT > 0 ? FT : 1];
  if constexpr (FT > 0) {
    load_row<FT>(gn, gv);
    active = active && scatter::any_nonzero<FT>(gv);
  } else {
    bool nz = false;
    for (int f = 0; f < F; ++f) nz = nz || gn[f] != 0.f;
    active = active && nz;
  }
  if (!__any_sync(scatter::kFullMask, active)) return;  // a warp of zero rows

  const Voxel v = voxel_geometry(x + n * 3, bmin, bmax, res[l]);
  const uint32_t mask = (1u << log2T) - 1u;
  const int level_base = l << log2T;
  // a hashed level: its (res+1)^3 vertices outnumber the table's rows.
  // s.l is warp-uniform, so the warp takes one grouping as a whole.
  const int64_t side = static_cast<int64_t>(res[s.l < L ? s.l : 0]) + 1;
  const bool hashed = side * side * side > (int64_t{1} << log2T);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int key = active ? static_cast<int>(corner_index(v, c, mask)) + level_base : -1;
    const float w = corner_weight(v, c);
    if constexpr (FT > 0) {
      float val[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) val[f] = __fmul_rn(w, gv[f]);
      if (hashed) {
        scatter::warp_run_add<FT>(key, val, d_table, FT);
      } else {
        scatter::warp_group_add<FT>(key, val, d_table, FT);
      }
    } else {
      for (int f = 0; f < F; ++f) {  // F is uniform, so the warp stays together
        float val[1] = {__fmul_rn(w, gn[f])};
        if (hashed) {
          scatter::warp_run_add<1>(key, val, d_table + f, F);
        } else {
          scatter::warp_group_add<1>(key, val, d_table + f, F);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_expand_kernel(const float* __restrict__ x, const float* __restrict__ bmin,
                              const float* __restrict__ bmax, const float* __restrict__ res,
                              const float* __restrict__ g, int* __restrict__ flat_idx,
                              float* __restrict__ vals, int64_t N, int L, int log2T, int F) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= N * L) return;
  const int l = static_cast<int>(t / N);
  const int64_t n = t - static_cast<int64_t>(l) * N;

  const Voxel v = voxel_geometry(x + n * 3, bmin, bmax, res[l]);
  const uint32_t mask = (1u << log2T) - 1u;
  const int level_base = l << log2T;
  const float* gn = g + n * L * F + static_cast<int64_t>(l) * F;
  const int64_t o = t * 8;  // t == l*N + n
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    flat_idx[o + c] = static_cast<int>(corner_index(v, c, mask)) + level_base;
    const float w = corner_weight(v, c);
    float* dst = vals + (o + c) * F;
    for (int f = 0; f < F; ++f) dst[f] = __fmul_rn(w, gn[f]);
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Threads of a level-group launch: ceil(L / GL) groups of Np * GL, with
// Np = N rounded up to 32.
struct Grid {
  int64_t Np, total;
};

inline Grid level_group_grid(long long N, int L, int GL) {
  const int64_t Np = (N + 31) / 32 * 32;
  return {Np, (L + GL - 1) / GL * Np * GL};
}

inline bool bad_args(int L, int log2T, int F, int GL) {
  return L < 1 || F < 1 || GL < 1 || log2T < 0 || log2T > 30;
}

}  // namespace

// GL is the number of levels in a group (clamped to L). Each entry returns a
// cudaError_t.
extern "C" int hash_encode_fwd(const void* table, const void* x, const void* bmin,
                               const void* bmax, const void* res, void* feats, void* keep,
                               long long N, int L, int log2T, int F, int GL, void* stream) {
  if (bad_args(L, log2T, F, GL)) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  GL = GL < L ? GL : L;
  const Grid grid = level_group_grid(N, L, GL);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const float*>(table);
  const auto* xp = static_cast<const float*>(x);
  const auto* lo = static_cast<const float*>(bmin);
  const auto* hi = static_cast<const float*>(bmax);
  const auto* r = static_cast<const float*>(res);
  auto* out = static_cast<float*>(feats);
  auto* k = static_cast<uint8_t*>(keep);
  const unsigned blocks = blocks_for(grid.total);
  switch (F) {
    case 2:
      hash_encode_fwd_kernel<2><<<blocks, kThreads, 0, s>>>(
          tab, xp, lo, hi, r, out, k, N, grid.Np, grid.total, L, log2T, F, GL);
      break;
    case 4:
      hash_encode_fwd_kernel<4><<<blocks, kThreads, 0, s>>>(
          tab, xp, lo, hi, r, out, k, N, grid.Np, grid.total, L, log2T, F, GL);
      break;
    case 8:
      hash_encode_fwd_kernel<8><<<blocks, kThreads, 0, s>>>(
          tab, xp, lo, hi, r, out, k, N, grid.Np, grid.total, L, log2T, F, GL);
      break;
    default:
      hash_encode_fwd_kernel<0><<<blocks, kThreads, 0, s>>>(
          tab, xp, lo, hi, r, out, k, N, grid.Np, grid.total, L, log2T, F, GL);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_table (L*T, F) must be zeroed by the caller; K6 adds into it.
extern "C" int hash_encode_bwd(const void* x, const void* bmin, const void* bmax,
                               const void* res, const void* g, void* d_table, long long N,
                               int L, int log2T, int F, int GL, void* stream) {
  if (bad_args(L, log2T, F, GL)) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return 0;
  GL = GL < L ? GL : L;
  const Grid grid = level_group_grid(N, L, GL);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* lo = static_cast<const float*>(bmin);
  const auto* hi = static_cast<const float*>(bmax);
  const auto* r = static_cast<const float*>(res);
  const auto* gp = static_cast<const float*>(g);
  auto* out = static_cast<float*>(d_table);
  const unsigned blocks = blocks_for(grid.total);
  switch (F) {
    case 2:
      hash_encode_bwd_kernel<2><<<blocks, kThreads, 0, s>>>(
          xp, lo, hi, r, gp, out, N, grid.Np, grid.total, L, log2T, F, GL);
      break;
    case 4:
      hash_encode_bwd_kernel<4><<<blocks, kThreads, 0, s>>>(
          xp, lo, hi, r, gp, out, N, grid.Np, grid.total, L, log2T, F, GL);
      break;
    case 8:
      hash_encode_bwd_kernel<8><<<blocks, kThreads, 0, s>>>(
          xp, lo, hi, r, gp, out, N, grid.Np, grid.total, L, log2T, F, GL);
      break;
    default:
      hash_encode_bwd_kernel<0><<<blocks, kThreads, 0, s>>>(
          xp, lo, hi, r, gp, out, N, grid.Np, grid.total, L, log2T, F, GL);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hash_encode_bwd_expand(const void* x, const void* bmin, const void* bmax,
                                      const void* res, const void* g, void* flat_idx,
                                      void* vals, long long N, int L, int log2T, int F,
                                      void* stream) {
  if (N <= 0) return 0;
  hash_encode_bwd_expand_kernel<<<blocks_for(N * L), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bmin),
      static_cast<const float*>(bmax), static_cast<const float*>(res),
      static_cast<const float*>(g), static_cast<int*>(flat_idx), static_cast<float*>(vals),
      N, L, log2T, F);
  return static_cast<int>(cudaGetLastError());
}
