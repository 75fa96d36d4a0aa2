// Fused bias add, activation, gain and clamp, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bias_act_kernel` of `bias_act_pallas`
// (animeface_tpu/ops/pallas_kernels.py). Forward only, as that kernel is.
//
// Function, for x viewed as [outer, C, inner] (C the bias axis) and element i:
//   v    = float(x[i]) + float(b[(i / inner) % C])      (b given in x's dtype)
//   v    = act(v, alpha)                                 (one of nine, below)
//   v    = v * gain                                      (when gain != 1)
//   v    = clip(v, -clamp, clamp)                        (when clamp >= 0)
//   y[i] = v, rounded once to x's dtype (f32 or bf16).
// CIPS's [B, S^2, C] and a [B, C] dense output have inner = 1; NCHW maps have
// inner = H * W.
//
// Bound: the call reads x and writes y once (the bias is tiny), a few flops an
// element, so it is bound by bytes: at CIPS's [16, 16384, 512] bf16, 512 MiB,
// 0.16 ms at 3.35 TB/s. The design moves nothing else: each thread loads and
// stores 16 bytes at a time (8 bf16 or 4 f32 values) with neighbouring
// threads on neighbouring addresses, computes in registers in f32, and takes
// the bias from L1. Where a 16-byte vector would mix channels (inner not a
// multiple of the vector width) or the pointers are not 16-byte aligned, the
// kernel runs one element a thread.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;   // grid-stride beyond this

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };

// Vector layouts: channels along the vector (inner == 1), one channel per
// vector (inner % width == 0), or one element per thread.
enum Mode { kChannelsLast = 0, kPlane = 1, kScalar = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The activations of `activation_funcs` (ops/bias_act.py), in f32.
__device__ __forceinline__ float activate(float v, int act, float alpha) {
  switch (act) {
    case kLinear: return v;
    case kRelu: return v < 0.f ? 0.f : v;
    case kLrelu: return v >= 0.f ? v : v * alpha;
    case kTanh: return tanhf(v);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    case kElu: return v > 0.f ? v : expm1f(v);
    case kSelu: return 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
    case kSoftplus: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    case kSwish: return v / (1.f + expf(-v));
  }
  return v;
}

template <typename T, int MODE, typename Index>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
                Index n, Index C, Index inner, int act, float alpha, float gain, float clamp) {
  constexpr int V = MODE == kScalar ? 1 : 16 / sizeof(T);
  const Index nv = n / V;                    // the host guarantees n % V == 0
  const Index stride = (Index)gridDim.x * kThreads;
  for (Index v = (Index)blockIdx.x * kThreads + threadIdx.x; v < nv; v += stride) {
    const Index i = v * V;
    alignas(16) T in[V];
    alignas(16) T out[V];
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(in) = __ldg(reinterpret_cast<const uint4*>(x) + v);
    } else {
      in[0] = x[i];
    }
    const Index c0 = MODE == kChannelsLast ? i % C : (i / inner) % C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const Index c = MODE == kChannelsLast ? c0 + k : c0;
      float val = activate(to_float(in[k]) + to_float(b[c]), act, alpha);
      if (gain != 1.f) val *= gain;
      if (clamp >= 0.f) val = fminf(fmaxf(val, -clamp), clamp);
      out[k] = from_float<T>(val);
    }
    if constexpr (V > 1) {
      reinterpret_cast<uint4*>(y)[v] = *reinterpret_cast<const uint4*>(out);
    } else {
      y[i] = out[0];
    }
  }
}

template <typename T, int MODE, typename Index>
void launch(const void* x, const void* b, void* y, int64_t n, int64_t C, int64_t inner, int act,
            float alpha, float gain, float clamp, cudaStream_t stream) {
  const int V = MODE == kScalar ? 1 : 16 / sizeof(T);
  int64_t blocks = (n / V + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  bias_act_kernel<T, MODE, Index><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y), (Index)n,
      (Index)C, (Index)inner, act, alpha, gain, clamp);
}

template <typename T, typename Index>
void dispatch_mode(const void* x, const void* b, void* y, int64_t n, int64_t C, int64_t inner,
                   int act, float alpha, float gain, float clamp, cudaStream_t stream) {
  const int64_t V = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) && n % V == 0;
  if (aligned && inner == 1 && C % V == 0) {
    launch<T, kChannelsLast, Index>(x, b, y, n, C, inner, act, alpha, gain, clamp, stream);
  } else if (aligned && inner % V == 0) {
    launch<T, kPlane, Index>(x, b, y, n, C, inner, act, alpha, gain, clamp, stream);
  } else {
    launch<T, kScalar, Index>(x, b, y, n, C, inner, act, alpha, gain, clamp, stream);
  }
}

template <typename T>
void dispatch_index(const void* x, const void* b, void* y, int64_t n, int64_t C, int64_t inner,
                    int act, float alpha, float gain, float clamp, cudaStream_t stream) {
  if (n < (int64_t(1) << 31)) {
    dispatch_mode<T, uint32_t>(x, b, y, n, C, inner, act, alpha, gain, clamp, stream);
  } else {
    dispatch_mode<T, int64_t>(x, b, y, n, C, inner, act, alpha, gain, clamp, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. act: the index of the activation in the Act
// enum above. clamp < 0 means no clamp. x, b and y are contiguous; b holds C
// values of x's dtype.
int bias_act_fwd(const void* x, const void* b, void* y, long long n, long long C,
                 long long inner, int dtype, int act, float alpha, float gain, float clamp,
                 void* stream) {
  if (n <= 0 || C <= 0 || inner <= 0 || act < kLinear || act > kSwish) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch_index<float>(x, b, y, n, C, inner, act, alpha, gain, clamp, s);
  } else if (dtype == 1) {
    dispatch_index<__nv_bfloat16>(x, b, y, n, C, inner, act, alpha, gain, clamp, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
