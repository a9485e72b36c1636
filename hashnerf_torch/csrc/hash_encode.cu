// K2 and K3: the hash-grid encode forward, and the corner expansion of its
// backward, for sm_90a.
//
// Replaces: hashnerf_tpu/kernels/hash_encode_vjp.py, hash_encode_fast.
//   K2 hash_encode_fwd   <- _fwd_impl (:63-74) with _corner_geometry (:33-54)
//   K3 hash_encode_bwd_expand <- _bwd_rule's recompute and corner expansion
//                           (:82-92); its segment-sum is K1 (segment_accum.cu)
// These are XLA functions on the TPU, not Pallas kernels; they carry the work
// around the Pallas kernel on the main path.
//
// K2: one thread per (point, level). It clips the point to the bbox, computes
//   the voxel geometry, hashes the 8 corners in uint32, gathers 8 x F floats
//   from table[l] and blends them with the trilinear weights into
//   feats[n, l*F:(l+1)*F]. keep[n] (inside the bbox before clipping) is
//   written once per point, by its level-0 thread.
// K3: one thread per (level, point). It recomputes the same geometry (only x
//   and the bbox are saved by the forward) and writes, for each corner c,
//   flat_idx[(l*N + n)*8 + c] = idx + l*T and vals[..., f] = cw * g[n, l*F+f]:
//   the (L, N, 8) layout the JAX backward hands to the segment-sum.
//
// What bounds them on the H100: bytes. K2 reads x (12 B a point), the table
//   rows it touches (F*4 B each, random 8-byte gathers at F = 2) and writes
//   L*F*4 B of features a point; K3 reads x and g and writes (4 + 4F) B for
//   each of the L*N*8 corners (302 MB at the chair fine pass). Integer hashing
//   and the blend are a few hundred operations a point-level, far below the
//   card's rate. Design: coalesced feature and corner writes (consecutive
//   threads write consecutive addresses), no shared memory, int64 offsets.
//
// Exactness: the geometry follows the JAX order
//   grid = (bmax-bmin)/res; rel = (xc-bmin)/grid; bl = floor(rel);
//   minv = bl*grid + bmin; w = (xc-minv)/grid
// with every operation rounded on its own (__f*_rn intrinsics, and the build
// passes --fmad=false and no fast math): an FMA or an approximate division can
// flip floor() at a cell boundary and select another hashed corner.

#include <cuda_runtime.h>
#include <cstdint>

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

__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                       const float* __restrict__ bmin, const float* __restrict__ bmax,
                       const float* __restrict__ res, float* __restrict__ feats,
                       uint8_t* __restrict__ keep, int64_t N, int L, int log2T, int F) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= N * L) return;
  const int64_t n = t / L;
  const int l = static_cast<int>(t - n * L);

  const Voxel v = voxel_geometry(x + n * 3, bmin, bmax, res[l]);
  const uint32_t mask = (1u << log2T) - 1u;
  const float* tab = table + (static_cast<int64_t>(l) << log2T) * F;

  uint32_t idx[8];
  float cw[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    idx[c] = corner_index(v, c, mask);
    cw[c] = corner_weight(v, c);
  }
  float* dst = feats + n * L * F + static_cast<int64_t>(l) * F;
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc = __fadd_rn(acc, __fmul_rn(cw[c], tab[static_cast<int64_t>(idx[c]) * F + f]));
    }
    dst[f] = acc;
  }
  if (l == 0) keep[n] = v.inside ? 1 : 0;
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

}  // namespace

extern "C" int hash_encode_fwd(const void* table, const void* x, const void* bmin,
                               const void* bmax, const void* res, void* feats, void* keep,
                               long long N, int L, int log2T, int F, void* stream) {
  if (N <= 0) return 0;
  hash_encode_fwd_kernel<<<blocks_for(N * L), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(x),
      static_cast<const float*>(bmin), static_cast<const float*>(bmax),
      static_cast<const float*>(res), static_cast<float*>(feats),
      static_cast<uint8_t*>(keep), N, L, log2T, F);
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
