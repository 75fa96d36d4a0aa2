// Fused bias add, activation, gain and clamp, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bias_act_kernel` of `bias_act_pallas`
// (animeface_tpu/ops/pallas_kernels.py). Forward only, as that kernel is.
//
// Function, for x viewed as [outer, C, inner] (C the bias axis) and element i:
//   v    = float(x[i]) + float(round_to_x_dtype(b[(i / inner) % C]))
//   v    = act(v, alpha)                                 (one of nine, below)
//   v    = v * gain                                      (when gain != 1)
//   v    = clip(v, -clamp, clamp)                        (when clamp >= 0)
//   y[i] = v, rounded once to x's dtype (f32 or bf16).
// The bias comes in x's dtype or in f32; an f32 bias is rounded to x's dtype
// (to nearest even, as b.to(x.dtype) rounds) before the add, so a caller
// need not cast it. CIPS's [B, S^2, C] and a [B, C] dense output have
// inner = 1; NCHW maps have inner = H * W.
//
// Bound: the call reads x and writes y once (the bias is tiny), a few flops an
// element, so it is bound by bytes: at CIPS's [16, 16384, 512] bf16, 537 MB,
// 0.1603 ms at 3.35 TB/s, far more than the 50 MB L2. The design moves
// nothing else and keeps the loop lean enough to hold eight 256-thread blocks
// an SM (at most 32 registers), each thread with one 16-byte load in flight:
//   * rows (inner == 1, C % V == 0, V = 16 / sizeof(T)): a block is
//     block_x x block_y threads; a thread owns one 16-byte column vector of
//     the row (block_x columns, the rest of a wide row on blockIdx.y), packs
//     its V bias values into one vector of registers once, and walks rows.
//     No index division and no bias load in the loop.
//   * planes (inner % V == 0): a thread row (threadIdx.y) owns one [outer, C]
//     plane at a time and reads its bias scalar once; the plane's vectors
//     are spread over threadIdx.x and blockIdx.y.
//   * scalar: one element a thread, for a misaligned x or an odd shape.
// Linear and lrelu (all of CIPS's calls) run kernels compiled for
// v >= 0 ? v : v * slope, with no switch on the activation; the other seven
// run kernels that switch. Index math is 32-bit below 2^31 elements. The grid
// covers the rows (planes) once, a block a step: measured on the H100, a
// resident grid whose blocks loop, or 2-4 rows a thread with their loads
// issued together, ran slower, and streaming cache hints gained nothing
// (PERF.md, section 6, row 8).
//
// The host (`bias_act_layout` in ops/cuda_kernels.py) picks the mode, the
// block and the grid, and passes them with the scalars in one parameter block
// (`BiasActParams`), memoised per call signature, so a call crosses ctypes
// with five arguments. The entry point launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// The parameter block, laid out as `_BiasActParams` in ops/cuda_kernels.py.
// Outside the unnamed namespace: the C entry point takes a pointer to it.
struct BiasActParams {
  long long n;        // elements of x
  long long C;        // bias length
  long long inner;    // elements after the bias axis
  long long rows;     // rows mode: n / C rows; planes mode: n / inner planes
  int mode, dtype, bias_f32, act;
  float alpha, gain, clamp;
  int grid_x, grid_y, block_x, block_y;
};

namespace {

constexpr int kThreads = 256;   // at most, a block (BIAS_ACT_THREADS in Python)
constexpr int kMinBlocks = 8;   // resident an SM for linear and lrelu: <= 32 registers

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };

// The kernel's layouts (BIAS_ACT_MODES in Python).
enum Mode { kRowsMode = 0, kPlanesMode = 1, kScalarMode = 2 };

using Params = BiasActParams;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// b[c] rounded to T (as b.to(x.dtype)), widened to f32.
template <typename T, typename B>
__device__ __forceinline__ float bias_value(const B* __restrict__ b, long long c) {
  return to_float(from_float<T>(to_float(b[c])));
}

// The activation, the gain and the clamp, in f32. kLeaky: linear or lrelu,
// v >= 0 ? v : v * slope (slope 1 for linear, alpha for lrelu), with no
// branch on the activation; else any of the nine activations of
// `activation_funcs` (ops/activations.py). Times the gain always: exact
// when gain is 1.
template <bool kLeaky>
__device__ __forceinline__ float finish(float v, float slope, const Params& p) {
  if constexpr (kLeaky) {
    v = v >= 0.f ? v : v * slope;
  } else {
    switch (p.act) {
      case kLinear: break;
      case kRelu: v = v < 0.f ? 0.f : v; break;
      case kLrelu: v = v >= 0.f ? v : v * p.alpha; break;
      case kTanh: v = tanhf(v); break;
      case kSigmoid: v = 1.f / (1.f + expf(-v)); break;
      case kElu: v = v > 0.f ? v : expm1f(v); break;
      case kSelu: v = 1.0507009873554805f * (v > 0.f ? v : 1.6732632423543772f * expm1f(v));
        break;
      case kSoftplus: v = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))); break;
      case kSwish: v = v / (1.f + expf(-v)); break;
    }
  }
  v *= p.gain;
  if (p.clamp >= 0.f) v = fminf(fmaxf(v, -p.clamp), p.clamp);
  return v;
}

__device__ __forceinline__ float slope_of(const Params& p) {
  return p.act == kLinear ? 1.f : p.alpha;
}

// 16-byte vectors hold V values of T as four words; a bf16 pair keeps its
// lower-indexed value in the low half. x, y and the bias travel so packed.

// The bias vector b[c0 + k * stride], k < V, each rounded to T.
template <typename T, typename B>
__device__ __forceinline__ uint4 bias_vector(const B* __restrict__ b, long long c0, int stride) {
  constexpr int V = 16 / sizeof(T);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (V == 4) {
      w[k] = __float_as_uint(bias_value<T>(b, c0 + k * stride));
    } else {      // rounded to bf16, so the low 16 bits of each f32 are zero
      w[k] = (__float_as_uint(bias_value<T>(b, c0 + 2 * k * stride)) >> 16) |
             __float_as_uint(bias_value<T>(b, c0 + (2 * k + 1) * stride));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// y = finish(x + bias) on one vector.
template <typename T, bool kLeaky>
__device__ __forceinline__ uint4 apply(uint4 xv, uint4 bv, float slope, const Params& p) {
  uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t c[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      w[k] = __float_as_uint(
          finish<kLeaky>(__uint_as_float(w[k]) + __uint_as_float(c[k]), slope, p));
    } else {
      const float lo = finish<kLeaky>(
          __uint_as_float(w[k] << 16) + __uint_as_float(c[k] << 16), slope, p);
      const float hi = finish<kLeaky>(
          __uint_as_float(w[k] & 0xffff0000u) + __uint_as_float(c[k] & 0xffff0000u), slope, p);
      w[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A thread owns one column vector of the row, with its bias, and walks the
// rows r, r + grid_x * block_y, ..: one 16-byte load and one store a row.
// Index is 32-bit when x has fewer than 2^31 elements.
template <typename T, typename B, bool kLeaky, typename Index>
__global__ void __launch_bounds__(kThreads, kLeaky ? kMinBlocks : 1)
bias_act_rows_kernel(const T* __restrict__ x, const B* __restrict__ b, T* __restrict__ y,
                     const Params p) {
  constexpr int V = 16 / sizeof(T);
  const Index cv = (Index)(p.C / V);            // vectors a row
  const Index col = (Index)blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= cv) return;
  const uint4 bias = bias_vector<T>(b, (long long)col * V, 1);
  const float slope = slope_of(p);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const Index rows = (Index)p.rows, step = (Index)gridDim.x * blockDim.y;
  for (Index r = (Index)blockIdx.x * blockDim.y + threadIdx.y; r < rows; r += step) {
    const Index i = r * cv + col;
    yv[i] = apply<T, kLeaky>(__ldg(xv + i), bias, slope, p);
  }
}

// A thread row (threadIdx.y) walks planes, reading each plane's bias once;
// in a plane, its threads take vectors v, v + grid_y * block_x, ...
template <typename T, typename B, bool kLeaky, typename Index>
__global__ void __launch_bounds__(kThreads, kLeaky ? kMinBlocks : 1)
bias_act_planes_kernel(const T* __restrict__ x, const B* __restrict__ b, T* __restrict__ y,
                       const Params p) {
  constexpr int V = 16 / sizeof(T);
  const Index iv = (Index)(p.inner / V);        // vectors a plane
  const Index planes = (Index)p.rows, step = (Index)gridDim.y * blockDim.x;
  const float slope = slope_of(p);
  for (Index plane = (Index)blockIdx.x * blockDim.y + threadIdx.y; plane < planes;
       plane += (Index)gridDim.x * blockDim.y) {
    const uint4 bias = bias_vector<T>(b, plane % (Index)p.C, 0);
    const uint4* xp = reinterpret_cast<const uint4*>(x) + plane * iv;
    uint4* yp = reinterpret_cast<uint4*>(y) + plane * iv;
    for (Index v = (Index)blockIdx.y * blockDim.x + threadIdx.x; v < iv; v += step) {
      yp[v] = apply<T, kLeaky>(__ldg(xp + v), bias, slope, p);
    }
  }
}

// One element a thread, any activation.
template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
bias_act_scalar_kernel(const T* __restrict__ x, const B* __restrict__ b, T* __restrict__ y,
                       const Params p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < p.n; i += stride) {
    const float v = to_float(x[i]) + bias_value<T>(b, (i / p.inner) % p.C);
    y[i] = from_float<T>(finish<false>(v, 0.f, p));
  }
}

template <typename T, typename B, bool kLeaky, typename Index>
void launch_vectors(const T* x, const B* b, T* y, const Params& p, cudaStream_t stream) {
  const dim3 grid(p.grid_x, p.grid_y), block(p.block_x, p.block_y);
  if (p.mode == kRowsMode) {
    bias_act_rows_kernel<T, B, kLeaky, Index><<<grid, block, 0, stream>>>(x, b, y, p);
  } else {
    bias_act_planes_kernel<T, B, kLeaky, Index><<<grid, block, 0, stream>>>(x, b, y, p);
  }
}

template <typename T, typename B, bool kLeaky>
void launch_index(const T* x, const B* b, T* y, const Params& p, cudaStream_t stream) {
  if (p.n < (1LL << 31)) {
    launch_vectors<T, B, kLeaky, uint32_t>(x, b, y, p, stream);
  } else {
    launch_vectors<T, B, kLeaky, long long>(x, b, y, p, stream);
  }
}

template <typename T, typename B>
void launch(const void* x, const void* b, void* y, const Params& p, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const B* bt = static_cast<const B*>(b);
  T* yt = static_cast<T*>(y);
  if (p.mode == kScalarMode) {
    bias_act_scalar_kernel<T, B><<<dim3(p.grid_x), dim3(p.block_x), 0, stream>>>(xt, bt, yt, p);
  } else if (p.act == kLinear || p.act == kLrelu) {
    launch_index<T, B, true>(xt, bt, yt, p, stream);
  } else {
    launch_index<T, B, false>(xt, bt, yt, p, stream);
  }
}

bool valid(const Params& p, const void* x, const void* y) {
  if (p.n <= 0 || p.C <= 0 || p.inner <= 0 || p.rows <= 0 || p.act < kLinear || p.act > kSwish ||
      p.grid_x <= 0 || p.grid_y <= 0 || p.grid_y > 65535 || p.block_x <= 0 || p.block_y <= 0 ||
      p.block_x * p.block_y > kThreads || (p.dtype != 0 && p.dtype != 1)) {
    return false;
  }
  if (p.mode == kScalarMode) return p.block_y == 1;
  const long long V = p.dtype == 0 ? 4 : 8;
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  if (p.mode == kRowsMode) return aligned && p.inner == 1 && p.C % V == 0 && p.rows * p.C == p.n;
  if (p.mode == kPlanesMode) return aligned && p.inner % V == 0 && p.rows * p.inner == p.n;
  return false;
}

}  // namespace

extern "C" {

// x, b and y are contiguous on the card; b holds C values, f32 (bias_f32) or
// of x's dtype (dtype: 0 float32, 1 bfloat16); `params` is a host pointer.
// act: the index of the activation in the Act enum above. clamp < 0 means no
// clamp. A block that does not fit the layout it names is refused.
int bias_act_fwd(const void* x, const void* b, void* y, const BiasActParams* params,
                 void* stream) {
  if (params == nullptr || !valid(*params, x, y)) return cudaErrorInvalidValue;
  const Params& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dtype == 0) {
    launch<float, float>(x, b, y, p, s);
  } else if (p.bias_f32) {
    launch<__nv_bfloat16, float>(x, b, y, p, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16>(x, b, y, p, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
