// Fused bias, 2x up-FIR, leaky ReLU, clamp and 2x down-FIR, for Hopper
// (sm_90a). Forward only.
//
// Replaces the three Pallas TPU variants of `filtered_lrelu_pallas`
// (animeface_tpu/ops/pallas_kernels.py): `_flrelu_kernel` (matmul),
// `_flrelu_kernel_gather` (the default) and `_flrelu_kernel_shift`. They
// compute one function; this is one kernel for it.
//
// Function, for each (n, c) plane of an NCHW x [N, C, H, W] (up = down = 2,
// separable filters, non-negative padding px0, py0 on the low sides):
//   xb[i, j]  = x[i, j] + b[c]                      (the zero padding stays 0)
//   u         = xb with a zero inserted after every sample along both axes,
//               padded by px0 / py0 zeros on the low sides
//   y[m, n]   = sum_{t, s} gu[t] gu[s] u[m + t - py0, n + s - px0]
//   e[m, n]   = clip((y >= 0 ? y : slope * y) * gain, -clamp, clamp)
//   out[k, l] = sum_{a, b} gd[a] gd[b] e[2k + a, 2l + b]
// with gu = flip(fu) * 2 (the up gain 4, split over the two axes) and
// gd = flip(fd): the orientation of upfirdn2d with flip_filter = False
// (convolution). Sums run in f32 and the output is rounded once to x's dtype
// (f32 or bf16); the bias arrives in x's dtype. A zero-inserted sample
// contributes nothing, so only the taps whose parity matches a row's phase
// are summed: about Lu / 2 a row and column.
//
// The TPU variants ran every FIR stage as banded matmuls on the MXU over
// DMA'd row slabs, with the 2x intermediate in VMEM. Here one block computes
// one 32 x 32 output tile of one plane, and the 2x intermediate lives only in
// shared memory, in f32:
//   1. load the tile's input window plus its halo (about 43 x 43 for 12 taps)
//      and add the bias inside the image;
//   2. up-FIR along H into yv [YH, IW], YH = 2 * 32 + Ld - 2 rows of y;
//   3. up-FIR along W, then the activation, gain and clamp, into
//      ys [YH, YW] (74 x 74 floats, 22 KB for 12 taps);
//   4. down-FIR along W into dw [YH, 32], over the region of stages 1-2;
//   5. down-FIR along H and one rounded store of the tile.
// Shared memory is about 43 KB a block for 12-tap filters; past 48 KB the
// dynamic shared memory attribute is raised (up to 227 KB).
//
// Bound: at the StyleGAN3-256 same-resolution shapes (B = 16, bf16, 12 taps)
// the call reads x and writes out once, and the separable polyphase work is
// about 6 + 6 + 12 + 12 multiply-adds per element of the four stages' outputs:
// at 272^2 x 128, 0.18 ms of bytes against 0.36 ms of f32 operations, so it is
// bound by operations. This first design reads its operands from shared
// memory one multiply-add at a time (shared memory, not the FMA units, limits
// it) and recomputes the halo of every tile (about 1.4x the y elements).
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;          // output rows and columns of a block
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // per-block dynamic shared memory on sm_90

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geometry {
  int YH, YW;   // rows and columns of the block's y region
  int IH, IW;   // rows and columns of its input window
};

__host__ __device__ inline Geometry geometry(int Lu, int Ld) {
  Geometry g;
  g.YH = g.YW = 2 * kTile + Ld - 2;
  g.IH = g.IW = (g.YH + Lu - 1) / 2 + 1;
  return g;
}

// floats: input window, yv, ys, and the taps
__host__ __device__ inline size_t smem_floats(int Lu, int Ld) {
  const Geometry g = geometry(Lu, Ld);
  return (size_t)g.IH * g.IW + (size_t)g.YH * g.IW + (size_t)g.YH * g.YW + Lu + Ld;
}

__device__ __forceinline__ int floor_half(int v) { return v >> 1; }   // arithmetic shift

template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
filtered_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                      const float* __restrict__ taps, T* __restrict__ out, int C, int H, int W,
                      int OH, int OW, int Lu, int Ld, int px0, int py0, float gain, float slope,
                      float clamp, int tiles_w, int tiles) {
  extern __shared__ float smem[];
  const Geometry g = geometry(Lu, Ld);
  float* xs = smem;                              // [IH][IW]
  float* yv = xs + g.IH * g.IW;                  // [YH][IW]
  float* ys = yv + g.YH * g.IW;                  // [YH][YW]
  float* gu = ys + g.YH * g.YW;                  // [Lu]
  float* gd = gu + Lu;                           // [Ld]
  float* dw = smem;                              // [YH][kTile], over xs and yv

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int64_t plane = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int k0 = (tile / tiles_w) * kTile;       // first output row / column
  const int l0 = (tile % tiles_w) * kTile;
  const int m0 = 2 * k0, n0 = 2 * l0;            // first y row / column
  const int i0 = floor_half(m0 - py0);           // first input row / column
  const int j0 = floor_half(n0 - px0);

  for (int t = tid; t < Lu + Ld; t += kThreadsX * kThreadsY) {
    (t < Lu ? gu[t] : gd[t - Lu]) = taps[t];
  }

  // 1. input window + halo, bias on the interior only
  const T* xp = x + plane * H * W;
  const float b = bias == nullptr ? 0.f : to_float(bias[plane % C]);
  for (int r = ty; r < g.IH; r += kThreadsY) {
    const int i = i0 + r;
    for (int c = tx; c < g.IW; c += kThreadsX) {
      const int j = j0 + c;
      float v = 0.f;
      if (i >= 0 && i < H && j >= 0 && j < W) v = to_float(xp[(int64_t)i * W + j]) + b;
      xs[r * g.IW + c] = v;
    }
  }
  __syncthreads();

  // 2. up-FIR along H: only taps t with m + t - py0 even meet a sample
  for (int r = ty; r < g.YH; r += kThreadsY) {
    const int m = m0 + r;
    const int t0 = (py0 - m) & 1;
    for (int c = tx; c < g.IW; c += kThreadsX) {
      float acc = 0.f;
      for (int t = t0; t < Lu; t += 2) {
        acc += gu[t] * xs[(floor_half(m + t - py0) - i0) * g.IW + c];
      }
      yv[r * g.IW + c] = acc;
    }
  }
  __syncthreads();

  // 3. up-FIR along W, leaky ReLU x gain, clamp
  for (int r = ty; r < g.YH; r += kThreadsY) {
    for (int c = tx; c < g.YW; c += kThreadsX) {
      const int n = n0 + c;
      float acc = 0.f;
      for (int s = (px0 - n) & 1; s < Lu; s += 2) {
        acc += gu[s] * yv[r * g.IW + floor_half(n + s - px0) - j0];
      }
      acc = (acc >= 0.f ? acc : acc * slope) * gain;
      if (clamp >= 0.f) acc = fminf(fmaxf(acc, -clamp), clamp);
      ys[r * g.YW + c] = acc;
    }
  }
  __syncthreads();

  // 4. down-FIR along W (dw reuses the input window's and yv's space)
  for (int r = ty; r < g.YH; r += kThreadsY) {
    for (int c = tx; c < kTile; c += kThreadsX) {
      float acc = 0.f;
      for (int a = 0; a < Ld; ++a) acc += gd[a] * ys[r * g.YW + 2 * c + a];
      dw[r * kTile + c] = acc;
    }
  }
  __syncthreads();

  // 5. down-FIR along H, one rounded store
  T* op = out + plane * OH * OW;
  for (int r = ty; r < kTile; r += kThreadsY) {
    const int k = k0 + r, l = l0 + tx;
    if (k >= OH || l >= OW) continue;
    float acc = 0.f;
    for (int a = 0; a < Ld; ++a) acc += gd[a] * dw[(2 * r + a) * kTile + tx];
    op[(int64_t)k * OW + l] = from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const void* bias, const void* taps, void* out, int N, int C, int H,
           int W, int OH, int OW, int Lu, int Ld, int px0, int py0, float gain, float slope,
           float clamp, cudaStream_t stream) {
  const size_t smem = smem_floats(Lu, Ld) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = filtered_lrelu_kernel<T>;
  if (smem > kStaticSmemLimit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_w = (OW + kTile - 1) / kTile;
  const int tiles = tiles_w * ((OH + kTile - 1) / kTile);
  const int64_t blocks = (int64_t)N * C * tiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, dim3(kThreadsX, kThreadsY), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<const float*>(taps),
      static_cast<T*>(out), C, H, W, OH, OW, Lu, Ld, px0, py0, gain, slope, clamp, tiles_w,
      tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. x [N, C, H, W] and out [N, C, OH, OW] are
// contiguous; bias holds C values of x's dtype, or is null; taps holds the
// Lu up taps gu then the Ld down taps gd, f32, oriented and scaled as in the
// header. clamp < 0 means no clamp.
int filtered_lrelu_fwd(const void* x, const void* bias, const void* taps, void* out, int N,
                       int C, int H, int W, int OH, int OW, int Lu, int Ld, int px0, int py0,
                       int dtype, float gain, float slope, float clamp, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || Lu <= 0 || Ld <= 0 ||
      px0 < 0 || py0 < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, bias, taps, out, N, C, H, W, OH, OW, Lu, Ld, px0, py0, gain, slope,
                         clamp, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, bias, taps, out, N, C, H, W, OH, OW, Lu, Ld, px0, py0,
                                 gain, slope, clamp, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
