// One line pass of the ADA two-pass warp, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (forward) and `_bwd_kernel`
// (backward) of `linepass_fused` in animeface_tpu/nnutils/ada_geometry_tpu.py.
// The warp takes this path for both of its passes when the image size fails
// the two-pass kernel's gate (N % 8 or We % 128), e.g. at 128px (We = 192).
//
// Function (per image b and channel c; z is [B,C,N,W], out is [B,C,out,W]):
//   v[l,w]   = (1-f[w]) z[mir_N((l+t[w]) mod P), w]
//            +    f[w]  z[mir_N((l+1+t[w]) mod P), w]               l < P
//   out[o,w] = sum_l M[o,l] v[l,w]                                  o < out
//   with P = 2N-2 and mir_n(j) = j < n ? j : 2n-2-j, one period of the
//   pixel-centre mirror extension. M is [B,out,Pp]; columns >= P are ignored.
//
// The TPU kernel read a materialised doubled canvas z2 [B,C,Pp,W], shifted it
// by radix rolls (Mosaic had no gather) and looped over channels inside one
// grid step. Here the mirrored, shifted read is index arithmetic on the
// undoubled map, so z2 never exists.
//
// Bound at the main-path shapes (B=32, C=3, 128px, f32):
//   pass 1: z [32,3,128,192], M [32,128,254] -> out [32,3,128,192];
//   pass 2: z [32,3,192,128], M [32,128,382] -> out [32,3,128,128];
// each call must read z and M and write out, 22-23 MB: about 7 us at
// 3.35 TB/s. M is banded (the kernel K vanishes for |t| >= 6.5: at most 13
// taps a row, wrapping cyclically), so the arithmetic the data needs is
// small and the call is bound by bytes. The design never multiplies the
// zeros of M: each warp compacts one row of M into (index, value) lists in
// shared memory with a ballot, then sums over those taps only, for every
// channel and column of its output line. M stays a plain input (any M gives
// the right answer). What it does not do yet: z is gathered through L1/L2
// (each element is read by ~13 output lines), and M is read whole, zeros
// included.
//
// Backward (the exact transpose; the gradient goes to z only; t, f and M are
// augment draws) runs in gather form, without atomics:
//   transpose M -> MT [B,P,out], so that a column of M becomes a row that a
//   warp can compact;
//   per (column tile, channel, image): dv = M^T g into shared memory, then
//   the blend and shift transposes and the mirror fold, which adds the two
//   doubled rows j and P-j that read input row j:
//   dz[j,w] = (1-f) dv[(j-t) mod P] + f dv[(j-t-1) mod P]
//           + [0 < j < N-1] ((1-f) dv[(P-j-t) mod P] + f dv[(P-j-t-1) mod P]).
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // columns per backward block
constexpr int kTileStride = kTile + 1;    // padded so lanes spread over banks
constexpr size_t kMaxSmem = 232448;       // per-block dynamic shared memory on sm_90
constexpr int kChunks = 16;               // 32-wide chunks of a row loaded per round

struct Dims {
  int B, C, N, W, P, Pp, out;
};

__device__ __forceinline__ int mirror(int j, int n) { return j < n ? j : 2 * n - 2 - j; }

__device__ __forceinline__ int wrap_up(int j, int p) { return j >= p ? j - p : j; }

__device__ __forceinline__ int wrap_down(int j, int p) { return j < 0 ? j + p : j; }

__device__ __forceinline__ int norm_shift(int t, int p) {
  t %= p;
  return t < 0 ? t + p : t;
}

// Warp-collective: write the nonzeros of row[0, len) to (idx, val) in
// ascending order and return their count. Each round issues the loads of
// kChunks chunks before the first ballot, so a row of up to 512 entries
// costs one memory latency instead of one per chunk.
__device__ int compact_row(const float* __restrict__ row, int len, int* idx, float* val) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int base = 0; base < len; base += 32 * kChunks) {
    float m[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int l = base + 32 * k + lane;
      m[k] = l < len ? __ldg(row + l) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const unsigned nz = __ballot_sync(0xffffffffu, m[k] != 0.f);
      if (m[k] != 0.f) {
        const int pos = n + __popc(nz & ((1u << lane) - 1u));
        idx[pos] = base + 32 * k + lane;
        val[pos] = m[k];
      }
      n += __popc(nz);
    }
  }
  __syncwarp();
  return n;
}

// grid (ceil(out / kWarps), B). One warp per output line o; lanes over
// columns; every channel of the image reuses the warp's tap list.
// Shared: tap lists, kWarps x P (index, value) pairs.
__global__ void __launch_bounds__(kThreads) linepass_fwd_kernel(
    const float* __restrict__ z, const int* __restrict__ t, const float* __restrict__ f,
    const float* __restrict__ M, float* __restrict__ out, Dims d) {
  extern __shared__ int smem_i[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx = smem_i + warp * d.P;
  float* val = reinterpret_cast<float*>(smem_i + kWarps * d.P) + warp * d.P;
  const int o = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (o >= d.out) return;                 // whole warps only: compact_row is collective

  const int n = compact_row(M + ((size_t)b * d.out + o) * d.Pp, d.P, idx, val);
  const size_t plane = (size_t)d.N * d.W;
  for (int w = lane; w < d.W; w += 32) {
    const int s = norm_shift(t[(size_t)b * d.W + w], d.P);
    const float fw = f[(size_t)b * d.W + w];
    for (int c = 0; c < d.C; ++c) {
      const float* zc = z + (size_t)(b * d.C + c) * plane + w;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) {
        const int j0 = wrap_up(idx[k] + s, d.P);
        const int j1 = wrap_up(j0 + 1, d.P);
        const float a = zc[(size_t)mirror(j0, d.N) * d.W];
        const float e = zc[(size_t)mirror(j1, d.N) * d.W];
        acc = fmaf(val[k], (1.f - fw) * a + fw * e, acc);
      }
      out[((size_t)(b * d.C + c) * d.out + o) * d.W + w] = acc;
    }
  }
}

// in [B, R, S] (first Cn columns used) -> out [B, Cn, R]. grid (ceil(Cn/32),
// ceil(R/32), B), block (32, 8).
__global__ void transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 int R, int S, int Cn) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32, b = blockIdx.z;
  const float* ib = in + (size_t)b * R * S;
  float* ob = out + (size_t)b * Cn * R;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, col = c0 + threadIdx.x;
    if (r < R && col < Cn) tile[i][threadIdx.x] = ib[(size_t)r * S + col];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int col = c0 + i, r = r0 + threadIdx.x;
    if (col < Cn && r < R) ob[(size_t)col * R + r] = tile[threadIdx.x][i];
  }
}

// grid (ceil(W / kTile), C, B). Shared: dv [P][kTile+1], tap lists
// (kWarps x out pairs).
__global__ void __launch_bounds__(kThreads) linepass_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ t, const float* __restrict__ f,
    const float* __restrict__ MT, float* __restrict__ dz, Dims d) {
  extern __shared__ float smem_f[];
  float* dv = smem_f;
  int* idx_all = reinterpret_cast<int*>(dv + (size_t)d.P * kTileStride);
  float* val_all = reinterpret_cast<float*>(idx_all + kWarps * d.out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx = idx_all + warp * d.out;
  float* val = val_all + warp * d.out;

  const int w = blockIdx.x * kTile + lane, c = blockIdx.y, b = blockIdx.z;
  const bool live = w < d.W;
  const float* gc = g + (size_t)(b * d.C + c) * d.out * d.W;

  // dv[l, w] = sum_o M[o, l] g[o, w]: one warp per l, lanes over columns
  for (int l = warp; l < d.P; l += kWarps) {
    const int n = compact_row(MT + ((size_t)b * d.P + l) * d.out, d.out, idx, val);
    float acc = 0.f;
    if (live)
      for (int k = 0; k < n; ++k) acc = fmaf(val[k], gc[(size_t)idx[k] * d.W + w], acc);
    dv[l * kTileStride + lane] = acc;
    __syncwarp();
  }
  __syncthreads();
  if (!live) return;

  const int s = norm_shift(t[(size_t)b * d.W + w], d.P);
  const float fw = f[(size_t)b * d.W + w];
  float* dzc = dz + (size_t)(b * d.C + c) * d.N * d.W + w;
  for (int j = warp; j < d.N; j += kWarps) {
    int i0 = wrap_down(j - s, d.P);
    int i1 = wrap_down(i0 - 1, d.P);
    float acc = (1.f - fw) * dv[i0 * kTileStride + lane] + fw * dv[i1 * kTileStride + lane];
    if (j > 0 && j < d.N - 1) {
      i0 = wrap_down(d.P - j - s, d.P);
      i1 = wrap_down(i0 - 1, d.P);
      acc += (1.f - fw) * dv[i0 * kTileStride + lane] + fw * dv[i1 * kTileStride + lane];
    }
    dzc[(size_t)j * d.W] = acc;
  }
}

size_t fwd_smem(const Dims& d) {
  return (sizeof(int) + sizeof(float)) * (size_t)kWarps * d.P;
}

size_t bwd_smem(const Dims& d) {
  return sizeof(float) * (size_t)d.P * kTileStride +
         (sizeof(int) + sizeof(float)) * (size_t)kWarps * d.out;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Dims make_dims(int B, int C, int N, int W, int P, int Pp, int out) {
  Dims d;
  d.B = B; d.C = C; d.N = N; d.W = W; d.P = P; d.Pp = Pp; d.out = out;
  return d;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory any launch of these shapes needs (bytes).
size_t ada_linepass_smem_bytes(int B, int C, int N, int W, int P, int Pp, int out_len) {
  const Dims d = make_dims(B, C, N, W, P, Pp, out_len);
  const size_t a = fwd_smem(d), b = bwd_smem(d);
  return a > b ? a : b;
}

int ada_linepass_fwd(const void* z, const void* t, const void* f, const void* M, void* out,
                     int B, int C, int N, int W, int P, int Pp, int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, W, P, Pp, out_len);
  const size_t smem = fwd_smem(d);
  cudaError_t err = allow_smem(linepass_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((out_len + kWarps - 1) / kWarps, B);
  linepass_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)z, (const int*)t, (const float*)f, (const float*)M, (float*)out, d);
  return (int)cudaGetLastError();
}

// Scratch: MT [B,P,out_len], f32.
int ada_linepass_bwd(const void* g, const void* t, const void* f, const void* M, void* dz,
                     void* MT, int B, int C, int N, int W, int P, int Pp, int out_len,
                     void* stream) {
  const Dims d = make_dims(B, C, N, W, P, Pp, out_len);
  cudaStream_t s = (cudaStream_t)stream;
  transpose_kernel<<<dim3((P + 31) / 32, (out_len + 31) / 32, B), dim3(32, 8), 0, s>>>(
      (const float*)M, (float*)MT, out_len, Pp, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem(d);
  err = allow_smem(linepass_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  linepass_bwd_kernel<<<dim3((W + kTile - 1) / kTile, C, B), kThreads, smem, s>>>(
      (const float*)g, (const int*)t, (const float*)f, (const float*)MT, (float*)dz, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
