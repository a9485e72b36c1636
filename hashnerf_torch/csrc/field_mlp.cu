// field_mlp: NeRFSmall's whole forward for a call that takes no gradient
// (frames, grid updates), with bf16 or float32 operands, for sm_90a.
//
// Replaces no TPU kernel. The JAX package's apply_nerf_small
// (hashnerf_tpu/models/nerf.py) multiplies each layer in a float32 dot, of
// bf16-rounded inputs and weights in the bf16 compute mode; XLA fuses the
// casts, the ReLUs and the concatenations into the dots. The port ran the
// same forward as PyTorch ops (models/nerf.py::NeRFSmall.forward_rays): for
// each of the five layers a float32 cuBLAS GEMM (behind a cast of the input
// and one of the weight to bf16 and back, in the bf16 mode) and a ReLU
// pass, and K9 / field_raw between the nets. Every one of those passes read
// and wrote 41.9 M points x 16-64 floats a 400 x 400 frame: 119 ms of the
// card's time a bf16 frame, 67 ms a float32 one. This kernel runs the whole
// net a point at a time, on chip:
//
//   sigma net:  h  = W1 relu(W0 x)                  x (N, 32), W0 (64, 32), W1 (16, 64)
//   colour net: c  = [views[n / S] | h[1:16]]        (Cv 16 + G 15 columns)
//               rgb = Wc2 relu(Wc1 relu(Wc0 c))      Wc0 (64, Cv + 15), Wc1 (64, 64), Wc2 (3, 64)
//   raw[n] = [rgb (3) | keep[n] ? h[0] : 0]
//
// Arithmetic: each output is the float32 chain acc = fmaf(a_k, w_k, acc)
// for k = 0, 1, ..., from 0: the order in which cuBLAS's float32 (FFMA)
// GEMM adds on the PyTorch route. On the card that route's GEMMs equal the
// chain bit for bit but for rare last bits (a few outputs in a million, at
// a million rows and more). Two instantiations of one body differ only in
// how a layer's operands are rounded (the net's compute type):
//   * bf16: every layer's input and weight are rounded to bf16 with
//     round-to-nearest-even (as `.to(torch.bfloat16)` rounds), so each
//     product is exact in float32 and the FMA is the product's sum. The
//     order matters because each hidden value is rounded to bf16 for the
//     next layer: summed in another order (mma.sync on the tensor cores,
//     with its own accumulation) about one output in 2,000 rounds the
//     other way, a step of one bf16 ulp, and those steps moved a rendered
//     pixel by up to 2.5e-3, beyond the benchmark's comparison with its
//     plain reference;
//   * float32: inputs and weights are used as they are, nothing is rounded
//     between the layers, and the FMA rounds the exact product's sum once.
// Sigma, the geo features and the rgb logits stay float32 until their
// consumer rounds them, as on the PyTorch route.
//
// What bounds it on the H100: the float32 multiply-adds on the CUDA cores,
// 9,344 a point, 3.9e11 a frame, 11.7 ms at 67 TFLOP/s; its bytes (128 of
// encoded floats, a keep byte and 16 of raw a point; a ray's 16 view floats
// once) take 1.8 ms at 3.35 TB/s. The design keeps the FMA units fed:
//   * persistent blocks, each staging the weights (bf16-rounded in the bf16
//     instantiation) into shared memory once, as float32 rows of a layer's
//     outputs for each input k; a warp's lanes read the same four weights
//     with one broadcast 16-byte load, which feeds each lane's two points:
//     8 FMAs a load. These loads hold it near half the FMA rate: with one
//     point a thread (4 FMAs a load) it took a third more time on the
//     render's passes, and more points a thread need more registers than
//     the FMAs gain;
//   * a thread runs two whole points; the layer's inputs sit in shared
//     memory, one value a point a row (a bf16, exact, in the bf16
//     instantiation; a float32 in the float32 one), read once for each k,
//     and its outputs accumulate in registers. Registers hold the bf16
//     instantiation to 2 blocks an SM (183 a thread); the float32 one's
//     192 registers and 101 KB of shared memory a block the same 2;
//   * a thread's row of encoded points is read as float4s, and each raw row
//     is one 16-byte store, a warp's rows adjacent.
// No atomics, no host sync, no allocation: the kernel is deterministic and
// captures into a CUDA graph. The two kernels are plain __global__ entries
// over one template body, so each demangled symbol starts with
// "(anonymous namespace)::field_mlp_gemm" (a template kernel's starts with
// its return type): it holds "gemm" so that the benchmark's MLP GEMM
// metrics count its time.

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
// then the layer inputs, [k][point] of the instantiation's type In.
constexpr int kW0 = 0;                        // 32 x 64
constexpr int kW1 = kW0 + kCx * kH;           // 64 x 16
constexpr int kWc0 = kW1 + kH * kO;           // (Cv + 15) x 64
constexpr int kWc1 = kWc0 + (kCv + kG) * kH;  // 64 x 64
constexpr int kWc2 = kWc1 + kH * kH;          // 64 x 4 (rgb, a zero column)
constexpr int kWeights = kWc2 + kH * 4;       // 9,408 floats
constexpr int kPoints = kThreads * kP;        // a block's points at once
template <typename In>
constexpr size_t kSmem = kWeights * sizeof(float) + size_t(kH) * kPoints * sizeof(In);

struct Weights {
  const float *w0, *w1, *wc0, *wc1, *wc2;
};

__device__ __forceinline__ __nv_bfloat16 bf16(float v) { return __float2bfloat16_rn(v); }

// A layer operand as the instantiation holds it: In = __nv_bfloat16 rounds
// it to bf16, In = float keeps it.
__device__ __forceinline__ float value(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float value(float v) { return v; }
template <typename In>
__device__ __forceinline__ In operand(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 operand<__nv_bfloat16>(float v) { return bf16(v); }
template <>
__device__ __forceinline__ float operand<float>(float v) { return v; }

// torch.relu: NaN stays NaN
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// acc[p][j] = the sum over k < K, in order, of in[k][p] * w[k][j]
template <int J, typename In>
__device__ __forceinline__ void layer(float (&acc)[kP][J], const In* in, const float* w, int K) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[p][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float a[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) a[p] = value(in[(k * kP + p) * kThreads]);
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

// in[j][p] = relu(acc[p][j]) as an operand: the next layer's input
template <int J, typename In>
__device__ __forceinline__ void store_relu(const float (&acc)[kP][J], In* in) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < J; ++j) in[(j * kP + p) * kThreads] = operand<In>(relu(acc[p][j]));
}

// point p's inputs k0 .. k0 + 3
template <typename In>
__device__ __forceinline__ void store4(In* in, int k0, int p, float4 v) {
  in[((k0 + 0) * kP + p) * kThreads] = operand<In>(v.x);
  in[((k0 + 1) * kP + p) * kThreads] = operand<In>(v.y);
  in[((k0 + 2) * kP + p) * kThreads] = operand<In>(v.z);
  in[((k0 + 3) * kP + p) * kThreads] = operand<In>(v.w);
}

// The whole forward of a block's points, operands held as In; the body of
// both kernels below.
template <typename In>
__device__ __forceinline__ void forward(const float* __restrict__ x,
                                        const float* __restrict__ views,
                                        const uint8_t* __restrict__ keep, Weights w,
                                        float* __restrict__ raw, unsigned N, unsigned S, int cv,
                                        long long sx, long long sv) {
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
    sw[i] = value(operand<In>(v));
  }
  __syncthreads();

  // this thread's column of the layer inputs
  In* in = reinterpret_cast<In*>(sw + kWeights) + threadIdx.x;
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
      for (int g = 0; g < kG; ++g) in[((cv + g) * kP + p) * kThreads] = operand<In>(o[p][1 + g]);
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

// bf16 operands
__global__ void __launch_bounds__(kThreads)
field_mlp_gemm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ views,
                          const uint8_t* __restrict__ keep, Weights w, float* __restrict__ raw,
                          unsigned N, unsigned S, int cv, long long sx, long long sv) {
  forward<__nv_bfloat16>(x, views, keep, w, raw, N, S, cv, sx, sv);
}

// float32 operands
__global__ void __launch_bounds__(kThreads)
field_mlp_gemm_f32_fwd_kernel(const float* __restrict__ x, const float* __restrict__ views,
                              const uint8_t* __restrict__ keep, Weights w,
                              float* __restrict__ raw, unsigned N, unsigned S, int cv,
                              long long sx, long long sv) {
  forward<float>(x, views, keep, w, raw, N, S, cv, sx, sv);
}

using KernelFn = void (*)(const float*, const float*, const uint8_t*, Weights, float*, unsigned,
                          unsigned, int, long long, long long);

inline bool misaligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);

// Checks the arguments (see the entries below) and launches kernel, whose
// layer inputs are In, on as many blocks as are resident at once.
template <typename In>
int launch(KernelFn kernel, const void* x, const void* views, const void* keep, const void* w0,
           const void* w1, const void* wc0, const void* wc1, const void* wc2, void* raw,
           long long N, long long S, int Cv, long long sx, long long sv, void* stream) {
  if (N < 0 || N >= kMaxRows || S < 1 || N % S || (Cv != 0 && Cv != kCv) ||
      (Cv == 0) != (views == nullptr) || sx < kCx || sx % 4 || misaligned16(x) ||
      misaligned16(raw) || (views != nullptr && (sv < Cv || sv % 4 || misaligned16(views))))
    return kBad;
  if (N == 0) return 0;
  // blocks resident at once on every SM, cached per device (one cache a
  // kernel: one a template instance)
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return kBad;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem<In>));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem<In>);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long groups = (N + kPoints - 1) / kPoints;
  const unsigned blocks = static_cast<unsigned>(groups < resident[dev] ? groups : resident[dev]);
  const Weights w{static_cast<const float*>(w0), static_cast<const float*>(w1),
                  static_cast<const float*>(wc0), static_cast<const float*>(wc1),
                  static_cast<const float*>(wc2)};
  kernel<<<blocks, kThreads, kSmem<In>, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(views),
      static_cast<const uint8_t*>(keep), w, static_cast<float*>(raw), static_cast<unsigned>(N),
      static_cast<unsigned>(S), Cv, sx, sv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries return a cudaError_t. x (N, 32) float32 with row stride sx
// floats; views (N / S, Cv) float32 with row stride sv, Cv 16, or null with
// Cv 0; keep (N,) bytes or null (every point kept); w0 (64, 32), w1 (16,
// 64), wc0 (64, Cv + 15), wc1 (64, 64), wc2 (3, 64) contiguous float32; raw
// (N, 4) contiguous. x, views and raw 16-byte aligned, strides multiples of
// 4 floats.

// A bf16-operand net's forward.
extern "C" int field_mlp_fwd(const void* x, const void* views, const void* keep, const void* w0,
                             const void* w1, const void* wc0, const void* wc1, const void* wc2,
                             void* raw, long long N, long long S, int Cv, long long sx,
                             long long sv, void* stream) {
  return launch<__nv_bfloat16>(field_mlp_gemm_fwd_kernel, x, views, keep, w0, w1, wc0, wc1, wc2,
                               raw, N, S, Cv, sx, sv, stream);
}

// A float32 net's forward.
extern "C" int field_mlp_fwd_f32(const void* x, const void* views, const void* keep,
                                 const void* w0, const void* w1, const void* wc0, const void* wc1,
                                 const void* wc2, void* raw, long long N, long long S, int Cv,
                                 long long sx, long long sv, void* stream) {
  return launch<float>(field_mlp_gemm_f32_fwd_kernel, x, views, keep, w0, w1, wc0, wc1, wc2, raw,
                       N, S, Cv, sx, sv, stream);
}
