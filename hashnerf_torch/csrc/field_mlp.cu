// field_mlp: NeRFSmall's whole forward with bf16 operands, for a call that
// takes no gradient (frames, grid updates), for sm_90a.
//
// Replaces no TPU kernel. The JAX package's apply_nerf_small
// (hashnerf_tpu/models/nerf.py) rounds each layer's input and weight to bf16
// and multiplies them in a float32 dot; XLA fuses the casts, the ReLUs and
// the concatenations into the dots. The port ran the same forward as
// PyTorch ops (models/nerf.py::NeRFSmall.forward_rays): for each of the five
// layers, a cast of the input to bf16 and back, one of the weight, a float32
// cuBLAS GEMM and a ReLU pass, and K9 / field_raw between the nets. Every one
// of those passes read and wrote 41.9 M points x 16-64 floats a 400 x 400
// frame, 119 ms of the card's time a frame. This kernel runs the whole net a
// point at a time, on chip:
//
//   sigma net:  h  = W1 relu(W0 x)                  x (N, 32), W0 (64, 32), W1 (16, 64)
//   colour net: c  = [views[n / S] | h[1:16]]        (Cv 16 + G 15 columns)
//               rgb = Wc2 relu(Wc1 relu(Wc0 c))      Wc0 (64, Cv + 15), Wc1 (64, 64), Wc2 (3, 64)
//   raw[n] = [rgb (3) | keep[n] ? h[0] : 0]
//
// Arithmetic: every layer's input and weight are rounded to bf16 with
// round-to-nearest-even (as `.to(torch.bfloat16)` rounds), and each output
// is the float32 sum of its products in the order cuBLAS's float32 GEMM adds
// them on the PyTorch route: k = 0, 1, ..., one fused multiply-add after
// another from 0 (a product of two bf16 values is exact in float32, so the
// FMA is the product's sum). On the card that route's GEMMs equal that chain
// bit for bit but for rare last bits (a few outputs in a million, at a
// million rows and more). The order matters because each hidden value is
// rounded to bf16 for the next layer: summed in another order (mma.sync on
// the tensor cores, with its own accumulation) about one output in 2,000
// rounds the other way, a step of one bf16 ulp, and those steps moved a
// rendered pixel by up to 2.5e-3, beyond the benchmark's comparison with its
// plain reference. Sigma, the geo features and the rgb logits stay float32
// until their consumer rounds them, as on the PyTorch route.
//
// What bounds it on the H100: the float32 multiply-adds on the CUDA cores,
// 9,344 a point, 3.9e11 a frame, 13 ms at 67 TFLOP/s; its bytes (128 of
// encoded floats, a keep byte and 16 of raw a point; a ray's 16 view floats
// once) take 1.8 ms at 3.35 TB/s. The design keeps the FMA units fed:
//   * persistent blocks, each staging the bf16-rounded weights into shared
//     memory once, as float32 rows of a layer's outputs for each input k;
//     a warp's lanes read the same four weights with one broadcast 16-byte
//     load, which feeds each lane's two points: 8 FMAs a load. These loads
//     hold it near half the FMA rate: with one point a thread (4 FMAs a
//     load) it took a third more time on the render's passes, and more
//     points a thread need more registers than the FMAs gain;
//   * a thread runs two whole points; the layer's inputs sit in shared
//     memory, one bf16 a point a row (exact: they are bf16 values), read
//     once for each k, and its outputs accumulate in registers;
//   * a thread's row of encoded points is read as float4s, and each raw row
//     is one 16-byte store, a warp's rows adjacent.
// No atomics, no host sync, no allocation: the kernel is deterministic and
// captures into a CUDA graph. The symbol holds "gemm" so that the
// benchmark's MLP GEMM metrics count its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kP = 2;            // points a thread runs at once: each weight load feeds 8 FMAs
constexpr int kCx = 32;          // encoded point width (the sigma net's input)
constexpr int kCv = 16;          // view encoding width, or 0
constexpr int kG = 15;           // geo features
constexpr int kH = 64;           // both nets' hidden width
constexpr int kO = 16;           // the sigma net's output: sigma and the geo features
constexpr long long kMaxRows = 1LL << 31;

// Shared memory: each layer's weights as [k][j] float32 (j padded to 4),
// then the layer inputs, [k][point] bf16.
constexpr int kW0 = 0;                        // 32 x 64
constexpr int kW1 = kW0 + kCx * kH;           // 64 x 16
constexpr int kWc0 = kW1 + kH * kO;           // (Cv + 15) x 64
constexpr int kWc1 = kWc0 + (kCv + kG) * kH;  // 64 x 64
constexpr int kWc2 = kWc1 + kH * kH;          // 64 x 4 (rgb, a zero column)
constexpr int kWeights = kWc2 + kH * 4;       // 9,408 floats
constexpr int kPoints = kThreads * kP;        // a block's points at once
constexpr size_t kSmem =
    kWeights * sizeof(float) + size_t(kH) * kPoints * sizeof(__nv_bfloat16);

struct Weights {
  const float *w0, *w1, *wc0, *wc1, *wc2;
};

__device__ __forceinline__ __nv_bfloat16 bf16(float v) { return __float2bfloat16_rn(v); }

// torch.relu: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// acc[p][j] = the sum over k < K, in order, of in[k][p] * w[k][j]
template <int J>
__device__ __forceinline__ void layer(float (&acc)[kP][J], const __nv_bfloat16* in,
                                      const float* w, int K) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[p][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) a[p] = __bfloat162float(in[(k * kP + p) * kThreads]);
#pragma unroll
    for (int j = 0; j < J; j += 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * J + j);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        acc[p][j] = fmaf(a[p], wv.x, acc[p][j]);
        acc[p][j + 1] = fmaf(a[p], wv.y, acc[p][j + 1]);
        acc[p][j + 2] = fmaf(a[p], wv.z, acc[p][j + 2]);
        acc[p][j + 3] = fmaf(a[p], wv.w, acc[p][j + 3]);
      }
    }
  }
}

// in[j][p] = bf16(relu(acc[p][j])): the next layer's input
template <int J>
__device__ __forceinline__ void store_relu(const float (&acc)[kP][J], __nv_bfloat16* in) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < J; ++j) in[(j * kP + p) * kThreads] = bf16(relu(acc[p][j]));
}

// point p's inputs k0 .. k0 + 3
__device__ __forceinline__ void store4(__nv_bfloat16* in, int k0, int p, float4 v) {
  in[((k0 + 0) * kP + p) * kThreads] = bf16(v.x);
  in[((k0 + 1) * kP + p) * kThreads] = bf16(v.y);
  in[((k0 + 2) * kP + p) * kThreads] = bf16(v.z);
  in[((k0 + 3) * kP + p) * kThreads] = bf16(v.w);
}

__global__ void __launch_bounds__(kThreads)
field_mlp_gemm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ views,
                          const uint8_t* __restrict__ keep, Weights w, float* __restrict__ raw,
                          unsigned N, unsigned S, int cv, long long sx, long long sv) {
  extern __shared__ float4 smem[];
  float* sw = reinterpret_cast<float*>(smem);
  const int cin = cv + kG;  // the colour net's input width
  for (int i = threadIdx.x; i < kWeights; i += kThreads) {
    float v;
    if (i < kW1) {
      v = w.w0[(i - kW0) % kH * kCx + (i - kW0) / kH];
    } else if (i < kWc0) {
      v = w.w1[(i - kW1) % kO * kH + (i - kW1) / kO];
    } else if (i < kWc1) {
      const int k = (i - kWc0) / kH;
      v = k < cin ? w.wc0[(i - kWc0) % kH * cin + k] : 0.f;
    } else if (i < kWc2) {
      v = w.wc1[(i - kWc1) % kH * kH + (i - kWc1) / kH];
    } else {
      const int j = (i - kWc2) % 4;
      v = j < 3 ? w.wc2[j * kH + (i - kWc2) / 4] : 0.f;
    }
    sw[i] = __bfloat162float(bf16(v));
  }
  __syncthreads();

  // this thread's column of the layer inputs
  __nv_bfloat16* in = reinterpret_cast<__nv_bfloat16*>(sw + kWeights) + threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned groups = (N + kPoints - 1) / kPoints;
  for (unsigned grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    unsigned n[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      n[p] = grp * kPoints + p * kThreads + threadIdx.x;
      const float4* xr = reinterpret_cast<const float4*>(x + n[p] * sx);
#pragma unroll
      for (int q = 0; q < kCx / 4; ++q) store4(in, 4 * q, p, n[p] < N ? __ldcs(xr + q) : zero);
    }
    // sigma net
    float h[kP][kH];
    layer(h, in, sw + kW0, kCx);
    store_relu(h, in);
    float o[kP][kO];
    layer(o, in, sw + kW1, kH);
    // colour net, on [views | geo features]
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (cv != 0) {
        const float4* vr = reinterpret_cast<const float4*>(views + (n[p] / S) * sv);
#pragma unroll
        for (int q = 0; q < kCv / 4; ++q) store4(in, 4 * q, p, n[p] < N ? __ldg(vr + q) : zero);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) in[((cv + g) * kP + p) * kThreads] = bf16(o[p][1 + g]);
    }
    layer(h, in, sw + kWc0, cin);
    store_relu(h, in);
    layer(h, in, sw + kWc1, kH);
    store_relu(h, in);
    float rgb[kP][4];
    layer(rgb, in, sw + kWc2, kH);
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (n[p] < N)
        reinterpret_cast<float4*>(raw)[n[p]] = make_float4(
            rgb[p][0], rgb[p][1], rgb[p][2], keep == nullptr || keep[n[p]] ? o[p][0] : 0.f);
  }
}

inline bool misaligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Returns a cudaError_t. x (N, 32) float32 with row stride sx floats; views
// (N / S, Cv) float32 with row stride sv, Cv 16, or null with Cv 0; keep (N,)
// bytes or null (every point kept); w0 (64, 32), w1 (16, 64), wc0 (64, Cv +
// 15), wc1 (64, 64), wc2 (3, 64) contiguous float32; raw (N, 4) contiguous.
// x, views and raw 16-byte aligned, strides multiples of 4 floats.
extern "C" int field_mlp_fwd(const void* x, const void* views, const void* keep, const void* w0,
                             const void* w1, const void* wc0, const void* wc1, const void* wc2,
                             void* raw, long long N, long long S, int Cv, long long sx,
                             long long sv, void* stream) {
  if (N < 0 || N >= kMaxRows || S < 1 || N % S || (Cv != 0 && Cv != kCv) ||
      (Cv == 0) != (views == nullptr) || sx < kCx || sx % 4 || misaligned16(x) ||
      misaligned16(raw) || (views != nullptr && (sv < Cv || sv % 4 || misaligned16(views))))
    return kBad;
  if (N == 0) return 0;
  // blocks resident at once on every SM, cached per device
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return kBad;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(field_mlp_gemm_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, field_mlp_gemm_fwd_kernel,
                                                          kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long groups = (N + kPoints - 1) / kPoints;
  const unsigned blocks = static_cast<unsigned>(groups < resident[dev] ? groups : resident[dev]);
  const Weights w{static_cast<const float*>(w0), static_cast<const float*>(w1),
                  static_cast<const float*>(wc0), static_cast<const float*>(wc1),
                  static_cast<const float*>(wc2)};
  field_mlp_gemm_fwd_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(views),
      static_cast<const uint8_t*>(keep), w, static_cast<float*>(raw), static_cast<unsigned>(N),
      static_cast<unsigned>(S), Cv, sx, sv);
  return static_cast<int>(cudaGetLastError());
}
