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
// DMA'd row slabs, with the 2x intermediate in VMEM. Here one block (256
// threads) computes one 32 x 32 output tile of one plane, and the 2x
// intermediate lives only in registers and shared memory, in f32:
//   1. load the tile's input window plus its halo (46 x 43 for K = 12: the
//      43 x 43 the tile reads and the rows stage 2's last run loads) and add
//      the bias inside the image;
//   2. up-FIR along H into yv [YH, IW], YH = 2 * 32 + K - 2 rows of y: a
//      thread takes kPairs2 row pairs of one column, lanes over columns;
//   3-4. up-FIR along W with the activation, gain and clamp, then the
//      down-FIR along W, into dw [YH, 33]: a thread takes kCols4 output
//      columns of one row of y, lanes over rows, and the up-sampled row
//      never leaves its registers;
//   5. down-FIR along H and one rounded store of the tile: a thread takes
//      kRows5 output rows of one column.
// Each run loads the window it reads into registers once and does all its
// multiply-adds from there. Shared memory is 30 KB a block for K = 12.
//
// Taps. Filters of up to 24 taps run `filtered_lrelu_kernel<T, K>`, compiled
// for a size class K (12 or 24; both filters zero-padded at their end to K
// taps: a zero tap adds no term) with the taps passed by value in the kernel
// parameters (`Taps<K>`, built by `filtered_lrelu_taps` in
// ops/cuda_kernels.py): unrolled, every multiply-add reads its tap from the
// constant bank, with no load. The up taps arrive split by phase: y row
// m = m0 + r (m0 even) sums up_h[r % 2][j] * x[ceil((m - py0) / 2) + j],
// j < K / 2, so a run computes the two rows of a pair with both phases' taps
// fixed at compile time; the pair's two windows start at the same input row
// when py0 is odd and one row apart when it is even (a uniform branch picks
// the run's instance; likewise along W with px0). Longer filters run
// `filtered_lrelu_loop_kernel`, the first design, which reads runtime tap
// counts from shared memory.
//
// Bound: at the StyleGAN3-256 same-resolution shapes (B = 16, bf16, 12 taps)
// the call reads x and writes out once, and the separable polyphase work is
// about 6 + 6 + 12 + 12 multiply-adds per element of the four stages' outputs:
// at 272^2 x 128, 0.18 ms of bytes against 0.36 ms of f32 operations, so it is
// bound by operations. Every tile recomputes its halo (1.14-1.48x the
// multiply-adds the four shapes need), and the runs of stages 3-4 recompute
// the K - 2 up-sampled columns where they meet.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

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

// floats of the loop kernel: input window, yv, ys, and the taps
__host__ __device__ inline size_t smem_floats(int Lu, int Ld) {
  const Geometry g = geometry(Lu, Ld);
  return (size_t)g.IH * g.IW + (size_t)g.YH * g.IW + (size_t)g.YH * g.YW + Lu + Ld;
}

// The templated kernel's region, sized from its class K, and its register
// runs: stage 2 takes kPairs2 row pairs of y a thread, stages 3-4 kCols4
// output columns of one row of y, stage 5 kRows5 output rows.
constexpr int kPairs2 = 8;
constexpr int kCols4 = 16;
constexpr int kRows5 = 8;
constexpr int kDwStride = kTile + 1;   // dw's row stride: lanes over rows hit 32 banks
// Blocks an SM the 12-tap class is compiled for (32 registers a thread, a
// small spill): the stages stall on shared and global loads more than on
// arithmetic, so more blocks in flight beat fewer spills.
constexpr int kMinBlocks12 = 7;

template <int K> struct Region {
  static constexpr int YH = 2 * kTile + K - 2;      // rows (and columns) of y
  static constexpr int IW = (YH + K - 1) / 2 + 1;   // columns of the window
  static constexpr int runs2 = (YH / 2 + kPairs2 - 1) / kPairs2;
  // rows of the window: those the y rows read, and those stage 2's last run
  // loads past them
  static constexpr int IH = runs2 * kPairs2 + K / 2 > IW ? runs2 * kPairs2 + K / 2 : IW;
  static constexpr size_t smem_floats =
      (size_t)IH * IW + (size_t)YH * IW + (size_t)YH * kDwStride;
};

// The taps of a size class, by value (see `filtered_lrelu_taps`).
template <int K> struct Taps {
  float up_h[2][K / 2];   // y row m sums up_h[m % 2]
  float up_w[2][K / 2];   // y column n sums up_w[n % 2]
  float down[K];          // gd
};

__device__ __forceinline__ int floor_half(int v) { return v >> 1; }   // arithmetic shift

__device__ __forceinline__ float activate(float v, float gain, float slope, float clamp) {
  v = (v >= 0.f ? v : v * slope) * gain;
  return clamp >= 0.f ? fminf(fmaxf(v, -clamp), clamp) : v;
}

// Stage 2 for one run of `pairs` (<= kPairs2) row pairs of one column: the
// kPairs2 + K / 2 window rows it reads are loaded once into registers, and
// every multiply-add takes its operand from there. Row 2s sums up_h[0] from
// window row s + OY, row 2s + 1 sums up_h[1] from row s + 1.
template <int K, int OY, int IW>
__device__ __forceinline__ void up_h_run(const float* col, float* dst, const Taps<K>& taps,
                                         int pairs) {
  float v[kPairs2 + K / 2];
#pragma unroll
  for (int t = 0; t < kPairs2 + K / 2; ++t) v[t] = col[t * IW];
#pragma unroll
  for (int s = 0; s < kPairs2; ++s) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      a0 = fmaf(taps.up_h[0][j], v[s + j + OY], a0);
      a1 = fmaf(taps.up_h[1][j], v[s + j + 1], a1);
    }
    if (s < pairs) {
      dst[2 * s * IW] = a0;
      dst[(2 * s + 1) * IW] = a1;
    }
  }
}

// Stages 3-4 for kCols4 output columns of one row of y. The samples of y the
// run reads along W are kCols4 + K - 1 values of yv, loaded once into
// registers; the 2 kCols4 + K - 2 up-sampled, activated values e are made in
// pairs (column 2u sums up_w[0] from yv column u + OX, 2u + 1 sums up_w[1]
// from u + 1) and each is added at once into the outputs whose down taps
// reach it, so no row of e is kept: out[i] = sum_a down[a] e[2i + a], summed
// in ascending a.
template <int K, int OX>
__device__ __forceinline__ void row_run(const float* row, float* dst, const Taps<K>& taps,
                                        float gain, float slope, float clamp) {
  constexpr int pairs = kCols4 + K / 2 - 1;
  float v[kCols4 + K - 1];
#pragma unroll
  for (int t = 0; t < kCols4 + K - 1; ++t) v[t] = row[t];
  float acc[kCols4];
#pragma unroll
  for (int i = 0; i < kCols4; ++i) acc[i] = 0.f;
#pragma unroll
  for (int u = 0; u < pairs; ++u) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      a0 = fmaf(taps.up_w[0][j], v[u + j + OX], a0);
      a1 = fmaf(taps.up_w[1][j], v[u + j + 1], a1);
    }
    const float e0 = activate(a0, gain, slope, clamp);
    const float e1 = activate(a1, gain, slope, clamp);
#pragma unroll
    for (int i = 0; i < kCols4; ++i) {
      const int a = 2 * (u - i);          // e0's tap in output i; e1's is a + 1
      if (a >= 0 && a < K) acc[i] = fmaf(taps.down[a], e0, acc[i]);
      if (a + 1 >= 0 && a + 1 < K) acc[i] = fmaf(taps.down[a + 1], e1, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kCols4; ++i) dst[i] = acc[i];
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreadsX * kThreadsY, K == 12 ? kMinBlocks12 : 1)
filtered_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ out,
                      const Taps<K> taps, int C, int H, int W, int OH, int OW, int px0, int py0,
                      float gain, float slope, float clamp, int tiles_w, int tiles) {
  using R = Region<K>;
  constexpr int YH = R::YH, IH = R::IH, IW = R::IW;
  extern __shared__ float smem[];
  float* xs = smem;                              // [IH][IW]
  float* yv = xs + IH * IW;                      // [YH][IW]
  float* dw = yv + YH * IW;                      // [YH][kDwStride]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t plane = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int k0 = (tile / tiles_w) * kTile;       // first output row / column
  const int l0 = (tile % tiles_w) * kTile;
  const int i0 = floor_half(2 * k0 - py0);       // first input row / column
  const int j0 = floor_half(2 * l0 - px0);
  // window offsets of a pair's first phase (the second's is 1)
  const int oy = py0 & 1, ox = px0 & 1;

  // 1. input window + halo, bias on the interior only
  const T* xp = x + plane * H * W;
  const float b = bias == nullptr ? 0.f : to_float(bias[plane % C]);
  for (int r = ty; r < IH; r += kThreadsY) {
    const int i = i0 + r;
    for (int c = tx; c < IW; c += kThreadsX) {
      const int j = j0 + c;
      float v = 0.f;
      if (i >= 0 && i < H && j >= 0 && j < W) v = to_float(xp[(int64_t)i * W + j]) + b;
      xs[r * IW + c] = v;
    }
  }
  __syncthreads();

  // 2. up-FIR along H: a thread takes kPairs2 row pairs of one column
  const int tid = ty * kThreadsX + tx;
  for (int item = tid; item < R::runs2 * IW; item += kThreadsX * kThreadsY) {
    const int s0 = item / IW * kPairs2, c = item % IW;
    const float* col = xs + s0 * IW + c;
    float* dst = yv + 2 * s0 * IW + c;
    const int pairs = min(kPairs2, YH / 2 - s0);
    if (oy) {
      up_h_run<K, 1, IW>(col, dst, taps, pairs);
    } else {
      up_h_run<K, 0, IW>(col, dst, taps, pairs);
    }
  }
  __syncthreads();

  // 3-4. up-FIR along W with the activation, gain and clamp, then the
  // down-FIR along W: a thread takes kCols4 output columns of one row of y,
  // lanes over rows (IW is odd, so yv's rows fall on 32 banks)
  for (int item = tid; item < kTile / kCols4 * YH; item += kThreadsX * kThreadsY) {
    const int r = item % YH, l = item / YH * kCols4;
    const float* row = yv + r * IW + l;
    float* dst = dw + r * kDwStride + l;
    if (ox) {
      row_run<K, 1>(row, dst, taps, gain, slope, clamp);
    } else {
      row_run<K, 0>(row, dst, taps, gain, slope, clamp);
    }
  }
  __syncthreads();

  // 5. down-FIR along H: a thread takes kRows5 output rows of one column,
  // one rounded store each
  T* op = out + plane * OH * OW;
  for (int item = tid; item < kTile / kRows5 * kTile; item += kThreadsX * kThreadsY) {
    const int r0 = item / kTile * kRows5, c = item % kTile;
    const int l = l0 + c;
    if (l >= OW) continue;
    float v[2 * kRows5 + K - 2];
#pragma unroll
    for (int t = 0; t < 2 * kRows5 + K - 2; ++t) v[t] = dw[(2 * r0 + t) * kDwStride + c];
#pragma unroll
    for (int r = 0; r < kRows5; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < K; ++a) acc = fmaf(taps.down[a], v[2 * r + a], acc);
      const int k = k0 + r0 + r;
      if (k < OH) op[(int64_t)k * OW + l] = from_float<T>(acc);
    }
  }
}

// The first design, for filters past the largest size class: runtime tap
// counts, the taps in shared memory, one multiply-add a loop iteration.
template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
filtered_lrelu_loop_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                           const float* __restrict__ taps, T* __restrict__ out, int C, int H,
                           int W, int OH, int OW, int Lu, int Ld, int px0, int py0, float gain,
                           float slope, float clamp, int tiles_w, int tiles) {
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
      ys[r * g.YW + c] = activate(acc, gain, slope, clamp);
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

// Raise the dynamic shared memory limit past 48 KB when a block needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Launch {
  int N, C, H, W, OH, OW, Lu, Ld, px0, py0;
  float gain, slope, clamp;
  cudaStream_t stream;
  int tiles_w() const { return (OW + kTile - 1) / kTile; }
  int tiles() const { return tiles_w() * ((OH + kTile - 1) / kTile); }
  int64_t blocks() const { return (int64_t)N * C * tiles(); }
};

template <typename T, int K>
int launch_class(const void* x, const void* bias, const float* host_taps, void* out,
                 const Launch& p) {
  Taps<K> taps;
  memcpy(&taps, host_taps, sizeof(taps));
  const size_t smem = Region<K>::smem_floats * sizeof(float);
  auto kernel = filtered_lrelu_kernel<T, K>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.blocks(), dim3(kThreadsX, kThreadsY), smem, p.stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<T*>(out), taps, p.C,
      p.H, p.W, p.OH, p.OW, p.px0, p.py0, p.gain, p.slope, p.clamp, p.tiles_w(), p.tiles());
  return (int)cudaGetLastError();
}

template <typename T>
int launch_loop(const void* x, const void* bias, const void* taps, void* out, const Launch& p) {
  const size_t smem = smem_floats(p.Lu, p.Ld) * sizeof(float);
  auto kernel = filtered_lrelu_loop_kernel<T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.blocks(), dim3(kThreadsX, kThreadsY), smem, p.stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bias), static_cast<const float*>(taps),
      static_cast<T*>(out), p.C, p.H, p.W, p.OH, p.OW, p.Lu, p.Ld, p.px0, p.py0, p.gain,
      p.slope, p.clamp, p.tiles_w(), p.tiles());
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* bias, const void* taps, const float* host_taps, void* out,
           int K, const Launch& p) {
  if (K == 12) return launch_class<T, 12>(x, bias, host_taps, out, p);
  if (K == 24) return launch_class<T, 24>(x, bias, host_taps, out, p);
  return launch_loop<T>(x, bias, taps, out, p);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. x [N, C, H, W] and out [N, C, OH, OW] are
// contiguous; bias holds C values of x's dtype, or is null. K = 12 or 24
// runs the templated kernel with host_taps, 3K f32 values on the host laid
// out as Taps<K> (copied into the launch's parameters); K = 0 runs the loop
// kernel with taps, the Lu up taps gu then the Ld down taps gd on the card,
// f32, oriented and scaled as in the header. clamp < 0 means no clamp.
int filtered_lrelu_fwd(const void* x, const void* bias, const void* taps, const float* host_taps,
                       void* out, int N, int C, int H, int W, int OH, int OW, int Lu, int Ld,
                       int K, int px0, int py0, int dtype, float gain, float slope, float clamp,
                       void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || Lu <= 0 || Ld <= 0 ||
      px0 < 0 || py0 < 0 || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (K == 12 || K == 24 ? host_taps == nullptr || Lu > K || Ld > K
                         : K != 0 || taps == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Launch p{N, C, H, W, OH, OW, Lu, Ld, px0, py0, gain, slope, clamp,
                 static_cast<cudaStream_t>(stream)};
  if (p.blocks() > 0x7fffffff) return cudaErrorInvalidValue;
  return dtype == 0 ? launch<float>(x, bias, taps, host_taps, out, K, p)
                    : launch<__nv_bfloat16>(x, bias, taps, host_taps, out, K, p);
}

}  // extern "C"
