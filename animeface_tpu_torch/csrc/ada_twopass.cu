// Two-pass ADA geometric warp, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pair `twopass_fused` in
// animeface_tpu/nnutils/ada_geometry_tpu.py: `_fwd2_kernel` (forward) and
// `_bwd2_kernel` (backward), both launched through `_call2`.
//
// Function (per image b and channel c; x is [B,C,N,Wep], out is [B,C,out,N]):
//   pass 1, per column w < We:
//     v1[l,w] = (1-f1[w]) x[mir_N((l+t1[w]) mod P1), w]
//             +    f1[w]  x[mir_N((l+1+t1[w]) mod P1), w]          l < P1
//     y1[r,w] = sum_l M1[r,l] v1[l,w]                              r < N
//   pass 2, per row r < N:
//     v2[l,r] = (1-f2[r]) y1[r, mir_We((l+t2[r]) mod P2)]
//             +    f2[r]  y1[r, mir_We((l+1+t2[r]) mod P2)]        l < P2
//     out[o,r] = sum_l M2[o,l] v2[l,r]                             o < out
//   with mir_n(j) = j < n ? j : 2n-2-j (one period of the pixel-centre
//   mirror extension, P1 = 2N-2, P2 = 2We-2). Columns of M at or beyond P
//   (the padding to P1p/P2p) are ignored, as in the TPU kernel.
//
// The TPU kernel built the mirror doubling as a matmul with constant
// matrices D1/D2 (Mosaic had no flip or transpose) and the per-column shift
// as radix rolls (Mosaic had no gather). Here both are index arithmetic.
//
// Bound at the main-path shapes (B=32, C=3, N=256, We=Wep=384, f32): the
// function must read x (1.18 MB per image), M1 (0.52 MB), M2 (0.79 MB) and
// write out (0.79 MB): 3.28 MB per image, 105 MB per call, 31 us at
// 3.35 TB/s. The arithmetic the data needs is small: M1/M2 are banded
// (K vanishes for |t| >= 6.5, at most 13 taps per row), so it is bound by
// bytes. Dense matmuls over M would be 19 GFLOP in f32 on CUDA cores,
// about ten times the byte bound, so this design never multiplies zeros:
// each warp compacts one row of M into (index, value) lists in shared
// memory with a ballot and then sums over those taps only. That keeps M a
// plain input (any M gives the right answer) while the work follows the
// band. What it does not yet do: every forward block re-reads the whole M2
// of its image and gathers x through L1/L2, so it moves several times the
// bound's bytes. Reading only the band of M, or evaluating K in-kernel, is
// the next step.
//
// Backward (the exact transpose; the gradient goes to x only) runs in
// gather form, without atomics:
//   transpose M1 -> M1T [B,P1,N] and M2 -> M2T [B,P2,out] so that columns
//   of M become rows that a warp can compact;
//   stage A (per row tile): dv2 = M2^T g, blend and shift transposes, and
//   the mirror undoubling of pass 2, giving dy1 [B,C,N,We];
//   stage B (per column tile): dv1 = M1^T dy1, blend and shift transposes,
//   and the row undoubling of pass 1, giving dx [B,C,N,Wep] (zero in
//   columns >= We).
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // rows (fwd, bwd A) or columns (bwd B) per block
constexpr int kTileStride = kTile + 1;    // padded so lanes spread over banks
constexpr size_t kMaxSmem = 232448;       // per-block dynamic shared memory on sm_90

struct Dims {
  int B, C, N, Wep, We, P1, P1p, P2, P2p, out;
};

__device__ __forceinline__ int mirror(int j, int n) { return j < n ? j : 2 * n - 2 - j; }

__device__ __forceinline__ int wrap_up(int j, int p) { return j >= p ? j - p : j; }

__device__ __forceinline__ int wrap_down(int j, int p) { return j < 0 ? j + p : j; }

__device__ __forceinline__ int norm_shift(int t, int p) {
  t %= p;
  return t < 0 ? t + p : t;
}

constexpr int kChunks = 16;               // 32-wide chunks of a row loaded per round

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

// grid (ceil(N / kTile), C, B). Shared: y1 tile [kTile][We+1], tap lists.
__global__ void __launch_bounds__(kThreads) twopass_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ t1, const float* __restrict__ f1,
    const float* __restrict__ M1, const int* __restrict__ t2, const float* __restrict__ f2,
    const float* __restrict__ M2, float* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  const int ys = d.We + 1;
  const int cap = max(d.P1, d.P2);
  float* y1 = smem;
  int* idx_all = reinterpret_cast<int*>(y1 + kTile * ys);
  float* val_all = reinterpret_cast<float*>(idx_all + kWarps * cap);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx = idx_all + warp * cap;
  float* val = val_all + warp * cap;

  const int r0 = blockIdx.x * kTile, c = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTile, d.N - r0);
  const float* xc = x + (size_t)(b * d.C + c) * d.N * d.Wep;

  // pass 1: one warp per row of the tile, lanes over columns
  for (int rr = warp; rr < rows; rr += kWarps) {
    const int n = compact_row(M1 + ((size_t)b * d.N + r0 + rr) * d.P1p, d.P1, idx, val);
    for (int w = lane; w < d.We; w += 32) {
      const int t = norm_shift(t1[(size_t)b * d.Wep + w], d.P1);
      const float f = f1[(size_t)b * d.Wep + w];
      float acc = 0.f;
      for (int k = 0; k < n; ++k) {
        const int j0 = wrap_up(idx[k] + t, d.P1);
        const int j1 = wrap_up(j0 + 1, d.P1);
        const float a = xc[(size_t)mirror(j0, d.N) * d.Wep + w];
        const float e = xc[(size_t)mirror(j1, d.N) * d.Wep + w];
        acc = fmaf(val[k], (1.f - f) * a + f * e, acc);
      }
      y1[rr * ys + w] = acc;
    }
    __syncwarp();
  }
  __syncthreads();

  // pass 2: one warp per output line o, lanes over the tile's rows
  float* outc = out + (size_t)(b * d.C + c) * d.out * d.N;
  const bool live = lane < rows;
  const int t = live ? norm_shift(t2[(size_t)b * d.N + r0 + lane], d.P2) : 0;
  const float f = live ? f2[(size_t)b * d.N + r0 + lane] : 0.f;
  const float* yr = y1 + lane * ys;
  for (int o = warp; o < d.out; o += kWarps) {
    const int n = compact_row(M2 + ((size_t)b * d.out + o) * d.P2p, d.P2, idx, val);
    if (live) {
      float acc = 0.f;
      for (int k = 0; k < n; ++k) {
        const int j0 = wrap_up(idx[k] + t, d.P2);
        const int j1 = wrap_up(j0 + 1, d.P2);
        acc = fmaf(val[k], (1.f - f) * yr[mirror(j0, d.We)] + f * yr[mirror(j1, d.We)], acc);
      }
      outc[(size_t)o * d.N + r0 + lane] = acc;
    }
    __syncwarp();
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

// Stage A. grid (ceil(N / kTile), C, B). Shared: dv2 [P2][kTile+1], tap lists.
__global__ void __launch_bounds__(kThreads) twopass_bwd_rows_kernel(
    const float* __restrict__ g, const int* __restrict__ t2, const float* __restrict__ f2,
    const float* __restrict__ M2T, float* __restrict__ dy1, Dims d) {
  extern __shared__ float smem[];
  float* dv = smem;
  int* idx_all = reinterpret_cast<int*>(dv + (size_t)d.P2 * kTileStride);
  float* val_all = reinterpret_cast<float*>(idx_all + kWarps * d.out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx = idx_all + warp * d.out;
  float* val = val_all + warp * d.out;

  const int r0 = blockIdx.x * kTile, c = blockIdx.y, b = blockIdx.z;
  const int rows = min(kTile, d.N - r0);
  const float* gc = g + (size_t)(b * d.C + c) * d.out * d.N;

  // dv2[l, r] = sum_o M2[o, l] g[o, r]: one warp per l, lanes over rows
  for (int l = warp; l < d.P2; l += kWarps) {
    const int n = compact_row(M2T + ((size_t)b * d.P2 + l) * d.out, d.out, idx, val);
    float acc = 0.f;
    if (lane < rows)
      for (int k = 0; k < n; ++k) acc = fmaf(val[k], gc[(size_t)idx[k] * d.N + r0 + lane], acc);
    dv[l * kTileStride + lane] = acc;
    __syncwarp();
  }
  __syncthreads();

  // dz(m) = (1-f) dv[(m-t) mod P2] + f dv[(m-t-1) mod P2];
  // dy1[r, w] = dz(w) + dz(P2-w) for interior w (mirror undoubling)
  for (int rr = warp; rr < rows; rr += kWarps) {
    const int r = r0 + rr;
    const int t = norm_shift(t2[(size_t)b * d.N + r], d.P2);
    const float f = f2[(size_t)b * d.N + r];
    float* dyr = dy1 + ((size_t)(b * d.C + c) * d.N + r) * d.We;
    for (int w = lane; w < d.We; w += 32) {
      int i0 = wrap_down(w - t, d.P2);
      int i1 = wrap_down(i0 - 1, d.P2);
      float s = (1.f - f) * dv[i0 * kTileStride + rr] + f * dv[i1 * kTileStride + rr];
      if (w > 0 && w < d.We - 1) {
        i0 = wrap_down(d.P2 - w - t, d.P2);
        i1 = wrap_down(i0 - 1, d.P2);
        s += (1.f - f) * dv[i0 * kTileStride + rr] + f * dv[i1 * kTileStride + rr];
      }
      dyr[w] = s;
    }
  }
}

// Stage B. grid (ceil(Wep / kTile), C, B). Shared: dv1 [P1][kTile+1], tap lists.
__global__ void __launch_bounds__(kThreads) twopass_bwd_cols_kernel(
    const float* __restrict__ dy1, const int* __restrict__ t1, const float* __restrict__ f1,
    const float* __restrict__ M1T, float* __restrict__ dx, Dims d) {
  extern __shared__ float smem[];
  float* dv = smem;
  int* idx_all = reinterpret_cast<int*>(dv + (size_t)d.P1 * kTileStride);
  float* val_all = reinterpret_cast<float*>(idx_all + kWarps * d.N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* idx = idx_all + warp * d.N;
  float* val = val_all + warp * d.N;

  const int w0 = blockIdx.x * kTile, c = blockIdx.y, b = blockIdx.z;
  const int cols = min(kTile, d.We - w0);     // live columns; <= 0 in the padding
  const int w = w0 + lane;
  const float* dyc = dy1 + (size_t)(b * d.C + c) * d.N * d.We;
  float* dxc = dx + (size_t)(b * d.C + c) * d.N * d.Wep;

  if (cols > 0) {
    // dv1[l, w] = sum_r M1[r, l] dy1[r, w]: one warp per l, lanes over columns
    for (int l = warp; l < d.P1; l += kWarps) {
      const int n = compact_row(M1T + ((size_t)b * d.P1 + l) * d.N, d.N, idx, val);
      float acc = 0.f;
      if (lane < cols)
        for (int k = 0; k < n; ++k) acc = fmaf(val[k], dyc[(size_t)idx[k] * d.We + w], acc);
      dv[l * kTileStride + lane] = acc;
      __syncwarp();
    }
  }
  __syncthreads();

  const bool live = lane < cols;
  const int t = live ? norm_shift(t1[(size_t)b * d.Wep + w], d.P1) : 0;
  const float f = live ? f1[(size_t)b * d.Wep + w] : 0.f;
  if (w >= d.Wep) return;
  for (int i = warp; i < d.N; i += kWarps) {
    float s = 0.f;
    if (live) {
      int i0 = wrap_down(i - t, d.P1);
      int i1 = wrap_down(i0 - 1, d.P1);
      s = (1.f - f) * dv[i0 * kTileStride + lane] + f * dv[i1 * kTileStride + lane];
      if (i > 0 && i < d.N - 1) {
        i0 = wrap_down(d.P1 - i - t, d.P1);
        i1 = wrap_down(i0 - 1, d.P1);
        s += (1.f - f) * dv[i0 * kTileStride + lane] + f * dv[i1 * kTileStride + lane];
      }
    }
    dxc[(size_t)i * d.Wep + w] = s;
  }
}

size_t fwd_smem(const Dims& d) {
  const int cap = d.P1 > d.P2 ? d.P1 : d.P2;
  return sizeof(float) * (size_t)kTile * (d.We + 1) + (sizeof(int) + sizeof(float)) * (size_t)kWarps * cap;
}

size_t bwd_rows_smem(const Dims& d) {
  return sizeof(float) * (size_t)d.P2 * kTileStride + (sizeof(int) + sizeof(float)) * (size_t)kWarps * d.out;
}

size_t bwd_cols_smem(const Dims& d) {
  return sizeof(float) * (size_t)d.P1 * kTileStride + (sizeof(int) + sizeof(float)) * (size_t)kWarps * d.N;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Dims make_dims(int B, int C, int N, int Wep, int We, int P1, int P1p, int P2, int P2p, int out) {
  Dims d;
  d.B = B; d.C = C; d.N = N; d.Wep = Wep; d.We = We;
  d.P1 = P1; d.P1p = P1p; d.P2 = P2; d.P2p = P2p; d.out = out;
  return d;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory any launch of these shapes needs (bytes).
size_t ada_twopass_smem_bytes(int B, int C, int N, int Wep, int We, int P1, int P1p, int P2,
                              int P2p, int out) {
  const Dims d = make_dims(B, C, N, Wep, We, P1, P1p, P2, P2p, out);
  size_t m = fwd_smem(d);
  if (bwd_rows_smem(d) > m) m = bwd_rows_smem(d);
  if (bwd_cols_smem(d) > m) m = bwd_cols_smem(d);
  return m;
}

int ada_twopass_fwd(const void* x, const void* t1, const void* f1, const void* M1,
                    const void* t2, const void* f2, const void* M2, void* out,
                    int B, int C, int N, int Wep, int We, int P1, int P1p, int P2, int P2p,
                    int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, Wep, We, P1, P1p, P2, P2p, out_len);
  const size_t smem = fwd_smem(d);
  cudaError_t err = allow_smem(twopass_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, C, B);
  twopass_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)t1, (const float*)f1, (const float*)M1, (const int*)t2,
      (const float*)f2, (const float*)M2, (float*)out, d);
  return (int)cudaGetLastError();
}

// Scratch: dy1 [B,C,N,We], M1T [B,P1,N], M2T [B,P2,out_len], all f32.
int ada_twopass_bwd(const void* g, const void* t1, const void* f1, const void* M1,
                    const void* t2, const void* f2, const void* M2, void* dx,
                    void* dy1, void* M1T, void* M2T,
                    int B, int C, int N, int Wep, int We, int P1, int P1p, int P2, int P2p,
                    int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, Wep, We, P1, P1p, P2, P2p, out_len);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 tblock(32, 8);
  transpose_kernel<<<dim3((P1 + 31) / 32, (N + 31) / 32, B), tblock, 0, s>>>(
      (const float*)M1, (float*)M1T, N, P1p, P1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  transpose_kernel<<<dim3((P2 + 31) / 32, (out_len + 31) / 32, B), tblock, 0, s>>>(
      (const float*)M2, (float*)M2T, out_len, P2p, P2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  size_t smem = bwd_rows_smem(d);
  err = allow_smem(twopass_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  twopass_bwd_rows_kernel<<<dim3((N + kTile - 1) / kTile, C, B), kThreads, smem, s>>>(
      (const float*)g, (const int*)t2, (const float*)f2, (const float*)M2T, (float*)dy1, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  smem = bwd_cols_smem(d);
  err = allow_smem(twopass_bwd_cols_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  twopass_bwd_cols_kernel<<<dim3((Wep + kTile - 1) / kTile, C, B), kThreads, smem, s>>>(
      (const float*)dy1, (const int*)t1, (const float*)f1, (const float*)M1T, (float*)dx, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
