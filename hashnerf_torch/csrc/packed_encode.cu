// K7 and K8: the packed-layout encode and its fused backward, for sm_90a.
//
// Replaces: hashnerf_tpu/ops/packed_grid.py:174-261, packed_encode, which
//   the JAX package leaves to XLA: the per-voxel table rebuilt from the
//   canonical dense vertices (build_packed_dense, :155-170), one take_rows
//   for the dense levels' 8F-float voxel rows and one for the fine levels'
//   27F-float slabs, and the einsum blends. Its backward is XLA's transpose
//   of those: the einsums' cotangents, the Pallas scatter-add
//   segment_accumulate_sorted (kernels/pallas_segment_accum.py:134) behind
//   take_rows (kernels/gather_vjp.py:18-36 -> kernels/segment_scatter.py),
//   and the 8 shifted adds of the rebuild.
//   K7 packed_encode_fwd: feats (N, L*F) in level order, keep (N,).
//   K8 packed_encode_bwd: d_dense (V, F) and d_fine (Lf * 2^B, 27F).
//
// The layout (ops/packed_grid.py): the Ld leading levels are dense vertex
// grids of (res+1)^3 rows of F floats, one after the other in the canonical
// table `dense`; the Lf fine levels are a table of Lf * 2^B slabs, each the
// 3x3x3 vertices (27 slots of F floats) of one 2x2x2-voxel macro-block,
// the slab row of voxel b being spatial_hash(b >> 1) mod 2^B + lf * 2^B.
// Corner c = (i, j, k) = (c >> 2, (c >> 1) & 1, c & 1) (BOX_OFFSETS order)
// of voxel b is
//   dense: vertex dense_off[l] + ((bx+i)(res+1) + (by+j))(res+1) + (bz+k);
//   fine:  slot (px+i)*9 + (py+j)*3 + (pz+k) of its slab, p = b & 1.
// So each of the 8 corners is one F-float row of one of the two tables,
// and in both the rows of corners k = 0 and k = 1 are neighbours.
//
// K7: one thread per (point, level), 32 points of one level a warp
//   (point-fastest), so a warp takes one branch and one table and
//   neighbouring samples of a ray share the coarse levels' rows in L1. It
//   clips the point, computes the voxel, reads the 8 corner rows straight
//   from `dense` or from the 8 live slots of the slab, a corner pair
//   (k = 0, 1: rows r, r + 1) as one stretch of 2F floats, and blends them
//   in float32 in corner order as they arrive. The features go through a
//   shared-memory tile, so a block writes whole (N, L*F) rows with
//   coalesced 16-byte stores; keep[n] (inside the bbox before clipping) is
//   written by the level-0 warp. No packed table is built and no slab is
//   gathered whole. Measured and not kept (PERF.md): L2 eviction policies
//   (the slab rows evict-first and past L1, the dense rows evict-last),
//   128-byte L2 fetches at the fine levels, and lanes loading a corner pair
//   together (4 lanes a 64-byte pair at F = 8).
// K8: one thread per (point, level), 32 points of one level a warp
//   (point-fastest, in groups of GL levels as K6 orders them), which along a
//   ray share corners at the coarse levels. It reads g once (a lane whose
//   row is all +-0 adds nothing, as in K6, and a warp of such lanes
//   returns), recomputes the geometry, and adds cw_c * g to each corner's
//   row with scatter_common.cuh::warp_group_add: the lanes of a warp that
//   hit one row are summed by shuffles and the sum goes to the L2 as one
//   vector reduction. No (N, 27F) cotangent, no packed gradient table and no
//   shifted add reaches device memory. The wrapper zeroes d_dense and
//   d_fine on the stream (no host synchronisation, so a CUDA graph holds it).
//
// What bounds them on the H100: bytes. K7 reads x, the corner rows the
// points touch (1.94M distinct rows, 62 MB, for 196,608 uniform points at
// L4 / F8; a fine corner pair is 2F floats, two 32-byte sectors at F = 8)
// and writes the features; K8 reads x and g and writes both gradient tables
// whole (117 MB at L4 / F8: 0.035 ms at 3.35 TB/s). The arithmetic is a few
// hundred float operations a (point, level), far below the card's rate.
// In practice K8 is held by the L2's reductions: N * L * 8 corners of F
// floats (12.6M 16-byte reductions at the fine pass before grouping), many
// onto the coarsest level's 4,913 vertices, and the fine levels' into 113
// MB of slabs that the 50 MB L2 does not hold (about 17-23 reductions a ns
// into such a table against 80 into one it holds: csrc/red_probe.cu). The
// run grouping of K6's hashed levels and a shared-memory box for the dense
// level 0 were measured and not kept. The times are in PERF.md.
//
// Exactness: the geometry is the plain version's, in its order,
//   grid = (hi - lo) / res; rel = (xc - lo) / grid;
//   b = clamp(floor(rel), 0, res - 1); w = rel - b
// with every operation rounded on its own (__f*_rn, and the build passes
// --fmad=false and no fast math): a contracted or approximate operation can
// flip floor() at a cell boundary and pick another row. This is not K2's
// voxel_geometry (hash_encode.cu), which leaves b unclamped and takes
// w = (xc - (b * grid + lo)) / grid. corner_weight and the hash constants
// are K2's.

#include <cuda_runtime.h>
#include <cstdint>

#include "scatter_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr int kMaxF = 8;
constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 805459861u;

// The levels, passed by value: a CUDA graph keeps them with its launch.
struct Levels {
  int n_dense;      // leading dense levels
  int n_fine;       // block-hashed levels after them
  int log2_blocks;  // B: slab rows a fine level, as log2
  int res[kMaxLevels];
  long long dense_off[kMaxLevels];  // first vertex of each dense level
};

struct Cell {
  int b[3];    // the voxel, clamped to [0, res - 1]
  float w[3];  // rel - b, in [0, 1]
};

// The point's clipped coordinates xc and whether it lies inside the bbox.
__device__ __forceinline__ bool clip_point(const float* __restrict__ x,
                                           const float* __restrict__ bmin,
                                           const float* __restrict__ bmax, float* lo, float* hi,
                                           float* xc) {
  bool inside = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = __ldg(bmin + d);
    hi[d] = __ldg(bmax + d);
    const float p = __ldg(x + d);
    inside = inside && (p >= lo[d]) && (p <= hi[d]);
    xc[d] = fminf(fmaxf(p, lo[d]), hi[d]);
  }
  return inside;
}

__device__ __forceinline__ Cell cell_geometry(const float* xc, const float* lo, const float* hi,
                                              int res) {
  Cell c;
  const float r = static_cast<float>(res);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float grid = __fdiv_rn(__fsub_rn(hi[d], lo[d]), r);
    const float rel = __fdiv_rn(__fsub_rn(xc[d], lo[d]), grid);
    const int b = min(max(static_cast<int>(floorf(rel)), 0), res - 1);
    c.b[d] = b;
    c.w[d] = __fsub_rn(rel, static_cast<float>(b));
  }
  return c;
}

// K2's trilinear weight of corner c (hash_encode.cu::corner_weight).
__device__ __forceinline__ float corner_weight(const Cell& v, int c) {
  const float wx = (c >> 2) ? v.w[0] : __fsub_rn(1.f, v.w[0]);
  const float wy = ((c >> 1) & 1) ? v.w[1] : __fsub_rn(1.f, v.w[1]);
  const float wz = (c & 1) ? v.w[2] : __fsub_rn(1.f, v.w[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The F-float rows of a voxel's corners in its level's table: corner c's
// row is base + i * si + j * sj + k.
struct CornerRows {
  int64_t base, si, sj;
};

__device__ __forceinline__ CornerRows corner_rows(const Levels& lv, int l, const Cell& c) {
  if (l < lv.n_dense) {
    const int64_t r1 = lv.res[l] + 1;
    return {lv.dense_off[l] + (c.b[0] * r1 + c.b[1]) * r1 + c.b[2], r1 * r1, r1};
  }
  // the slab of macro-block b >> 1 (spatial_hash in uint32, masked to B bits)
  const uint32_t h = (static_cast<uint32_t>(c.b[0] >> 1) * 1u) ^
                     (static_cast<uint32_t>(c.b[1] >> 1) * kP1) ^
                     (static_cast<uint32_t>(c.b[2] >> 1) * kP2);
  const int64_t row = static_cast<int64_t>(h & ((1u << lv.log2_blocks) - 1u)) +
                      (static_cast<int64_t>(l - lv.n_dense) << lv.log2_blocks);
  return {row * 27 + (c.b[0] & 1) * 9 + (c.b[1] & 1) * 3 + (c.b[2] & 1), 9, 3};
}

__device__ __forceinline__ int64_t corner_row(const CornerRows& r, int c) {
  return r.base + (c >> 2) * r.si + ((c >> 1) & 1) * r.sj + (c & 1);
}

// The 2F floats of rows r and r + 1 (a corner pair k = 0, 1), one stretch,
// as vectors of VW = 4, 2 or 1 floats (the widest that divides F, so every
// row is aligned to it when the table is), through the read-only path:
// the coarse levels' rows are read many times.
template <int F>
__device__ __forceinline__ void load_pair(const float* p, float* v) {
  constexpr int VW = scatter::vec_width<F>();
#pragma unroll
  for (int f = 0; f < 2 * F; f += VW) {
    if constexpr (VW == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + f));
      v[f] = t.x; v[f + 1] = t.y; v[f + 2] = t.z; v[f + 3] = t.w;
    } else if constexpr (VW == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p + f));
      v[f] = t.x; v[f + 1] = t.y;
    } else {
      v[f] = __ldg(p + f);
    }
  }
}

// The blend of the voxel's 8 corner rows of `tab`, corner by corner in
// order c = 0..7 (each pair k = 0, 1 blended as it arrives), into the F
// floats at t.
template <int F>
__device__ __forceinline__ void blend(const float* __restrict__ tab, const CornerRows& rows,
                                      const Cell& cell, float* t) {
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // corners c = 2p (k = 0) and 2p + 1 (k = 1)
    float v[2 * F];
    load_pair<F>(tab + corner_row(rows, 2 * p) * F, v);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float w = corner_weight(cell, 2 * p + k);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, v[k * F + f]));
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) t[f] = acc[f];
}

// K7's block: 32 * pw points and every level of them, as pw * L warp items:
// item i is level i % L of the points of point warp i / L (32 points of one
// level a warp, so the warp takes one branch and one table, and
// neighbouring samples of a ray share the coarse levels' rows); warp w
// takes items w, w + kFwdWarps, .... Each thread puts its F features into
// the block's tile (row stride `stride` floats: padded against bank
// conflicts), and the block then writes its whole (32 * pw, L * F) rows of
// feats, 16 bytes a thread where L * F is a multiple of 4.
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;

template <int F>
__global__ void __launch_bounds__(kFwdThreads, 4)
packed_encode_fwd_kernel(const float* __restrict__ dense, const float* __restrict__ fine,
                         const float* __restrict__ x, const float* __restrict__ bmin,
                         const float* __restrict__ bmax, float* __restrict__ feats,
                         uint8_t* __restrict__ keep, int64_t N, const Levels lv, int pw,
                         int stride) {
  extern __shared__ float tile[];
  const int L = lv.n_dense + lv.n_fine;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * 32 * pw;

  for (int item = warp; item < pw * L; item += kFwdWarps) {
    const int p = item / L;
    const int l = item - p * L;  // the same in the whole warp
    const int64_t n = n0 + p * 32 + lane;
    const int64_t nc = n < N ? n : N - 1;  // a lane past N computes a point it does not write
    float lo[3], hi[3], xc[3];
    const bool inside = clip_point(x + nc * 3, bmin, bmax, lo, hi, xc);
    const Cell cell = cell_geometry(xc, lo, hi, lv.res[l]);
    const CornerRows rows = corner_rows(lv, l, cell);
    // one call a table: measured faster than one call on a selected table
    float* t = tile + (p * 32 + lane) * stride + l * F;
    if (l < lv.n_dense) {
      blend<F>(dense, rows, cell, t);
    } else {
      blend<F>(fine, rows, cell, t);
    }
    if (l == 0 && n < N) keep[n] = inside ? 1 : 0;
  }
  __syncthreads();

  const int LF = L * F;
  const int nrows = static_cast<int>(N - n0 < 32 * pw ? N - n0 : 32 * pw);
  float* dst = feats + n0 * LF;
  if (LF % 4 == 0) {
    const int q4 = LF / 4;
    for (int i = threadIdx.x; i < nrows * q4; i += kFwdThreads) {
      const int r = i / q4, c = i - r * q4;
      *reinterpret_cast<float4*>(dst + r * LF + c * 4) =
          *reinterpret_cast<const float4*>(tile + r * stride + c * 4);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * LF; i += kFwdThreads) {
      const int r = i / LF;
      dst[i] = tile[r * stride + (i - r * LF)];
    }
  }
}

// K8's (point, level) of thread t (hash_encode.cu::point_fastest_slot): 32
// points of one level a warp, the next warps the group's other levels of
// those points, groups of GL levels outermost. Np is N rounded up to 32.
struct Slot {
  int64_t n;
  int l;
};

__device__ __forceinline__ Slot point_fastest_slot(int64_t t, int64_t Np, int GL) {
  const int64_t per_group = Np * GL;
  const int64_t grp = t / per_group;
  const int64_t w = (t - grp * per_group) >> 5;  // the warp's rank in its group
  Slot s;
  s.n = (w / GL) * 32 + (t & 31);
  s.l = static_cast<int>(grp) * GL + static_cast<int>(w % GL);
  return s;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
packed_encode_bwd_kernel(const float* __restrict__ x, const float* __restrict__ bmin,
                         const float* __restrict__ bmax, const float* __restrict__ g,
                         float* __restrict__ d_dense, float* __restrict__ d_fine, int64_t N,
                         int64_t Np, int64_t total, int GL, const Levels lv) {
  constexpr int VW = scatter::vec_width<F>();
  const int L = lv.n_dense + lv.n_fine;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // total is a multiple of 32 and blocks start at multiples of 32, so this
  // and the return below leave whole warps; a padding lane, or one whose
  // cotangent row is zero, stays with key -1 for the full-mask votes of
  // warp_group_add
  if (t >= total) return;
  const Slot s = point_fastest_slot(t, Np, GL);
  // s.l is the same for the 32 lanes of a warp, so the warp takes one
  // branch below (dense or fine) as a whole
  const bool level_ok = s.l < L;
  bool active = level_ok && s.n < N;
  const int l = level_ok ? s.l : 0;
  const int64_t n = active ? s.n : 0;

  float gv[F];
  const float* gn = g + n * L * F + static_cast<int64_t>(l) * F;
#pragma unroll
  for (int f = 0; f < F; f += VW) scatter::load_vec<VW>(gn + f, gv + f);
  active = active && scatter::any_nonzero<F>(gv);
  if (!__any_sync(scatter::kFullMask, active)) return;  // a warp of zero rows

  float lo[3], hi[3], xc[3];
  clip_point(x + n * 3, bmin, bmax, lo, hi, xc);
  const Cell cell = cell_geometry(xc, lo, hi, lv.res[l]);
  const CornerRows rows = corner_rows(lv, l, cell);
  float* tab = l < lv.n_dense ? d_dense : d_fine;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // rows of either table fit an int: the wrapper checks
    const int key = active ? static_cast<int>(corner_row(rows, c)) : -1;
    const float w = corner_weight(cell, c);
    float val[F];
#pragma unroll
    for (int f = 0; f < F; ++f) val[f] = __fmul_rn(w, gv[f]);
    scatter::warp_group_add<F>(key, val, tab, F);
  }
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Levels from the host arrays res (n_dense + n_fine) and dense_off
// (n_dense); false if they are out of range.
inline bool make_levels(Levels* lv, int n_dense, int n_fine, const int* res,
                        const long long* dense_off, int log2_blocks) {
  const int L = n_dense + n_fine;
  if (n_dense < 0 || n_fine < 0 || L < 1 || L > kMaxLevels || log2_blocks < 0 ||
      log2_blocks > 30) {
    return false;
  }
  lv->n_dense = n_dense;
  lv->n_fine = n_fine;
  lv->log2_blocks = log2_blocks;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv->res[l] = l < L ? res[l] : 1;
    lv->dense_off[l] = l < n_dense ? dense_off[l] : 0;
    if (l < L && lv->res[l] < 1) return false;
  }
  return true;
}

}  // namespace

// F (features a level) from 1 to 8; an F outside that, or levels out of
// range, return cudaErrorInvalidValue. Each entry returns a cudaError_t.
#define PACKED_DISPATCH_F(LAUNCH)                        \
  switch (F) {                                           \
    case 1: LAUNCH(1); break;                            \
    case 2: LAUNCH(2); break;                            \
    case 3: LAUNCH(3); break;                            \
    case 4: LAUNCH(4); break;                            \
    case 5: LAUNCH(5); break;                            \
    case 6: LAUNCH(6); break;                            \
    case 7: LAUNCH(7); break;                            \
    case 8: LAUNCH(8); break;                            \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// K7's block shape for L levels of F floats: (pw, tile row stride in floats)
inline void fwd_block(int L, int F, int* pw, int* stride) {
  *pw = L < kFwdWarps ? kFwdWarps / L : 1;
  const int LF = L * F;
  *stride = LF % 4 == 0 ? LF + 4 : (LF | 1);
}

extern "C" int packed_encode_fwd(const void* dense, const void* fine, const void* x,
                                 const void* bmin, const void* bmax, void* feats, void* keep,
                                 long long N, int n_dense, int n_fine, const int* res,
                                 const long long* dense_off, int log2_blocks, int F,
                                 void* stream) {
  Levels lv;
  if (!make_levels(&lv, n_dense, n_fine, res, dense_off, log2_blocks) || F < 1 || F > kMaxF ||
      (n_dense > 0 && dense == nullptr) || (n_fine > 0 && fine == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int pw = 0, stride = 0;
  fwd_block(n_dense + n_fine, F, &pw, &stride);
  const unsigned blocks = static_cast<unsigned>((N + 32 * pw - 1) / (32 * pw));
  const size_t smem = static_cast<size_t>(32) * pw * stride * sizeof(float);  // <= 33,280 bytes
  const auto* dp = static_cast<const float*>(dense);
  const auto* fp = static_cast<const float*>(fine);
  const auto* xp = static_cast<const float*>(x);
  const auto* lo = static_cast<const float*>(bmin);
  const auto* hi = static_cast<const float*>(bmax);
  auto* out = static_cast<float*>(feats);
  auto* k = static_cast<uint8_t*>(keep);
#define PACKED_FWD(FV)                                                                        \
  packed_encode_fwd_kernel<FV><<<blocks, kFwdThreads, smem, s>>>(dp, fp, xp, lo, hi, out, k, N, \
                                                                 lv, pw, stride)
  PACKED_DISPATCH_F(PACKED_FWD)
#undef PACKED_FWD
  return static_cast<int>(cudaGetLastError());
}

// d_dense (V, F) and d_fine (Lf * 2^B, 27F) must be zeroed by the caller; K8
// adds into them. GL is the number of levels in a group (clamped to L).
extern "C" int packed_encode_bwd(const void* x, const void* bmin, const void* bmax,
                                 const void* g, void* d_dense, void* d_fine, long long N,
                                 int n_dense, int n_fine, const int* res,
                                 const long long* dense_off, int log2_blocks, int F, int GL,
                                 void* stream) {
  Levels lv;
  if (!make_levels(&lv, n_dense, n_fine, res, dense_off, log2_blocks) || F < 1 || F > kMaxF ||
      GL < 1 || (n_dense > 0 && d_dense == nullptr) || (n_fine > 0 && d_fine == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return 0;
  const int L = n_dense + n_fine;
  GL = GL < L ? GL : L;
  const int64_t Np = (N + 31) / 32 * 32;
  const int64_t total = (L + GL - 1) / GL * Np * GL;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(total);
  const auto* xp = static_cast<const float*>(x);
  const auto* lo = static_cast<const float*>(bmin);
  const auto* hi = static_cast<const float*>(bmax);
  const auto* gp = static_cast<const float*>(g);
  auto* dd = static_cast<float*>(d_dense);
  auto* df = static_cast<float*>(d_fine);
#define PACKED_BWD(FV)                                                                    \
  packed_encode_bwd_kernel<FV><<<blocks, kThreads, 0, s>>>(xp, lo, hi, gp, dd, df, N, Np, \
                                                           total, GL, lv)
  PACKED_DISPATCH_F(PACKED_BWD)
#undef PACKED_BWD
  return static_cast<int>(cudaGetLastError());
}
