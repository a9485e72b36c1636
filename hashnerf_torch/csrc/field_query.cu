// K9 field_colour_input and field_raw: the field query's hand-off to the
// colour net and the raw it returns, for sm_90a.
//
// Replaces no TPU kernel. The JAX package concatenates [view encoding, geo
// features] for NeRFSmall's colour net (hashnerf_tpu/models/nerf.py,
// apply_nerf_small) and [rgb, sigma] under the keep mask
// (hashnerf_tpu/models/factory.py, query_fn); XLA fuses these
// concatenations and the select into their consumers, so they cost it no
// pass of their own. Written as PyTorch `cat`s over every sample they ran at
// a small part of the card's bandwidth (rows of 4 to 48 floats). The field
// query now encodes the view directions once a ray (models/factory.py), and
// these kernels widen them to the samples and write each row once:
//
//   field_colour_input_fwd: out[n] = [views[n / S] (Cv) | h[n, 1:1+G] (G) | 0 ...]
//     in rows of P floats, P = Cv + G rounded up to 4. Each thread stores
//     one 16-byte vector, so a warp writes 512 contiguous bytes; the colour
//     net's GEMM reads out[:, :Cv+G] with a leading dimension of P (32 at
//     Cv 16, G 15), which cuBLAS takes without a copy.
//   field_colour_input_bwd: d_h[n] = [0 | g[n, Cv:Cv+G]], the geo columns of
//     the colour input's cotangent in the sigma net's output layout. The
//     views' gradient is not the kernel's (directions carry none on the
//     field query's path; kernels/field_query.py sums it where views
//     require one).
//   field_raw_fwd: raw[n] = [rgb[n] (3) | keep[n] ? h[n, 0] : 0], one 16-byte
//     store a row (keep may be null: every point kept).
//   field_raw_bwd: d_h[n] = [keep[n] ? g[n, 3] : 0 | 0 ...]; rgb's cotangent
//     is g[:, :3] itself, which the wrapper hands on as a view.
//
// What bounds them on the H100: bytes, each read and written once. A sample
// of the colour input reads G = 15 geo floats (60 bytes) and writes Cv + G =
// 31 floats (124 bytes), and its ray's 16 view floats are read once a ray
// (64 / S bytes a sample): about 184 bytes a sample, 0.346 ms for the render
// chunk's fine pass (32,768 rays x 192 samples) at 3.35 TB/s. The pad float
// that makes a row P = 32 floats, for 16-byte stores, is this design's own:
// 4 bytes more a sample (0.0075 ms at that pass). The
// design meets that bound by touching nothing twice: one pass over the
// output rows; the S samples of a ray read its views row from the L1 / L2
// after the first; h's rows are 64 bytes and a warp's 32 lanes read 4
// whole rows (256 contiguous bytes) with scalar loads, since the geo columns
// start at float 1 and cannot be read as aligned vectors. field_raw reads
// 12 + 4 + 1 bytes a sample (sigma's 4 bytes cost the 32-byte sector of a
// 64-byte h row) and writes 16. The backwards write d_h (64 bytes a sample)
// from the cotangent's columns, one float a thread.
//
// Every value is a copy or +0: the kernels are exact, and equal their plain
// versions (kernels/field_query.py) bit for bit. Thread indices are 32-bit:
// each entry refuses a launch of 2^31 threads or more, and every argument
// its kernel cannot take, with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxThreads = 1LL << 31;

__global__ void __launch_bounds__(kThreads)
field_colour_input_fwd_kernel(const float* __restrict__ views, const float* __restrict__ h,
                              float* __restrict__ out, unsigned total, unsigned V, unsigned S,
                              int Cv, int G, long long sv, long long sh) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned n = t / V;  // the row; its vector is t - n * V
  const int c0 = static_cast<int>(t - n * V) * 4;
  const long long vrow = static_cast<long long>(n / S) * sv;
  const long long hrow = static_cast<long long>(n) * sh + 1 - Cv;  // + c: geo column c - Cv
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c0 + k;
    v[k] = c < Cv ? __ldg(views + vrow + c) : (c < Cv + G ? __ldg(h + hrow + c) : 0.f);
  }
  // row n, column c0 of rows of P = 4V floats: float 4t
  *reinterpret_cast<float4*>(out + 4 * static_cast<long long>(t)) =
      make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads)
field_colour_input_bwd_kernel(const float* __restrict__ g, float* __restrict__ d_h,
                              unsigned total, int H, int Cv, long long sg) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned n = t / H;
  const int j = static_cast<int>(t - n * H);
  d_h[t] = j == 0 ? 0.f : __ldg(g + static_cast<long long>(n) * sg + Cv + j - 1);
}

__global__ void __launch_bounds__(kThreads)
field_raw_fwd_kernel(const float* __restrict__ rgb, const float* __restrict__ h,
                     const uint8_t* __restrict__ keep, float* __restrict__ raw, unsigned N,
                     long long sr, long long sh) {
  const unsigned n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* r = rgb + static_cast<long long>(n) * sr;
  const bool kept = keep == nullptr || keep[n];
  const float sigma = kept ? __ldg(h + static_cast<long long>(n) * sh) : 0.f;
  *reinterpret_cast<float4*>(raw + 4 * static_cast<long long>(n)) =
      make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), sigma);
}

__global__ void __launch_bounds__(kThreads)
field_raw_bwd_kernel(const float* __restrict__ g, const uint8_t* __restrict__ keep,
                     float* __restrict__ d_h, unsigned total, int H, long long sg) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned n = t / H;
  const bool sigma = t == n * H && (keep == nullptr || keep[n]);
  d_h[t] = sigma ? __ldg(g + static_cast<long long>(n) * sg + 3) : 0.f;
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

inline bool misaligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Each entry returns a cudaError_t. Strides are in floats; columns are
// adjacent (stride 1). out (N, P) and raw (N, 4) must be 16-byte aligned.
extern "C" int field_colour_input_fwd(const void* views, const void* h, void* out, long long N,
                                      long long S, int Cv, int G, int P, long long sv,
                                      long long sh, void* stream) {
  if (N < 0 || S < 1 || N % S || Cv < 0 || G < 0 || P % 4 || P < Cv + G || sv < 0 || sh < 0 ||
      (Cv > 0 && views == nullptr) || misaligned16(out) || N * (P / 4) >= kMaxThreads)
    return kBad;
  const long long total = N * (P / 4);
  if (total == 0) return 0;
  field_colour_input_fwd_kernel<<<blocks_for(total), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(views), static_cast<const float*>(h), static_cast<float*>(out),
      static_cast<unsigned>(total), static_cast<unsigned>(P / 4), static_cast<unsigned>(S), Cv,
      G, sv, sh);
  return static_cast<int>(cudaGetLastError());
}

// d_h (N, H) contiguous, H = 1 + G; g (N, >= Cv + G) with row stride sg.
extern "C" int field_colour_input_bwd(const void* g, void* d_h, long long N, int H, int Cv,
                                      long long sg, void* stream) {
  if (N < 0 || H < 1 || Cv < 0 || sg < 0 || N * H >= kMaxThreads) return kBad;
  if (N * H == 0) return 0;
  field_colour_input_bwd_kernel<<<blocks_for(N * H), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(d_h), static_cast<unsigned>(N * H), H,
      Cv, sg);
  return static_cast<int>(cudaGetLastError());
}

// rgb (N, 3) with row stride sr, h's column 0 with row stride sh, keep (N,)
// bytes or null.
extern "C" int field_raw_fwd(const void* rgb, const void* h, const void* keep, void* raw,
                             long long N, long long sr, long long sh, void* stream) {
  if (N < 0 || sr < 0 || sh < 0 || misaligned16(raw) || N >= kMaxThreads) return kBad;
  if (N == 0) return 0;
  field_raw_fwd_kernel<<<blocks_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(h),
      static_cast<const uint8_t*>(keep), static_cast<float*>(raw), static_cast<unsigned>(N), sr,
      sh);
  return static_cast<int>(cudaGetLastError());
}

// d_h (N, H) contiguous; g (N, >= 4) with row stride sg; keep as above.
extern "C" int field_raw_bwd(const void* g, const void* keep, void* d_h, long long N, int H,
                             long long sg, void* stream) {
  if (N < 0 || H < 1 || sg < 0 || N * H >= kMaxThreads) return kBad;
  if (N * H == 0) return 0;
  field_raw_bwd_kernel<<<blocks_for(N * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const uint8_t*>(keep), static_cast<float*>(d_h),
      static_cast<unsigned>(N * H), H, sg);
  return static_cast<int>(cudaGetLastError());
}
