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
// zeros of M: it lists M's nonzeros once per call and sums over those taps
// only, which keeps M a plain input (any M gives the right answer).
//
// Forward, in two launches, the two-pass forward's pass 1 on one matrix:
//   row lists: a warp per row of M (compact_row) writes its nonzeros as
//   (column, value), ascending, and a count: cnt [B,out], idx/val
//   [B,out,P];
//   fused (per tile of kFwdRows output lines, all channels): a warp per
//   line, its first 32 taps in registers; per chunk of 32 columns the
//   window of z's lines that the tile's taps reach at those columns'
//   shifts is copied into shared memory with cp.async, double-buffered,
//   and the gathers read it there with lane = column (read straight from z,
//   a warp's loads would hit about 12 lines of 128 bytes each, as the
//   shifts change from column to column); a window too long for the
//   buffers (dense M) is read from z through L1/L2. The output lines go
//   straight to memory, coalesced along w.
// Backward (the exact transpose; the gradient goes to z only; t, f and M
// are augment draws), in two launches, the two-pass backward's stage B on
// one matrix:
//   tap lists: one pass over M, a lane per column l < P, writes each
//   column's nonzeros as (row, value), ascending, and a count: cnt [B,P],
//   idx/val [B,P,out];
//   gather (per tile of kSub columns, all channels): g's tile into shared
//   memory, dv = M^T g from the lists, then the blend and shift transposes
//   and the mirror fold onto N lines, which adds the two doubled lines j
//   and P-j that read input line j:
//   dz[j,w] = (1-f) dv[(j-t) mod P] + f dv[(j-t-1) mod P]
//           + [0 < j < N-1] ((1-f) dv[(P-j-t) mod P] + f dv[(P-j-t-1) mod P]).
// No atomics: every output element is one thread's sum over an ascending
// list, so two calls give bitwise-equal outputs. The lists, gathers and
// window staging are in ada_warp_common.cuh, shared with ada_twopass.cu.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include "ada_warp_common.cuh"

namespace {

using namespace ada_warp;

constexpr int kListThreads = 256;         // the row-list kernel, a warp per row
constexpr int kListWarps = kListThreads / 32;

struct Dims {
  int B, C, N, W, P, Pp, out;
};

// grid (ceil(out / kListWarps), B): the row lists of M.
__global__ void __launch_bounds__(kListThreads) linepass_row_lists_kernel(
    const float* __restrict__ M, Lists rl, Dims d) {
  const int o = blockIdx.x * kListWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (o >= d.out) return;                  // the whole warp: compact_row is warp-collective
  const size_t row = (size_t)b * d.out + o;
  const int n = compact_row(M + row * d.Pp, d.P, rl.idx + row * d.P, rl.val + row * d.P);
  if ((threadIdx.x & 31) == 0) rl.cnt[row] = n;
}

// grid (ceil(out / kFwdRows), B), 32 * kFwdRows threads: a tile of output
// lines over every chunk of 32 columns, so that one chunk's copies fly
// while the last one is summed. Shared: two staging buffers [cc][cap][32],
// the shifts and blends [W] each.
__global__ void __launch_bounds__(32 * kFwdRows) linepass_fwd_kernel(
    const float* __restrict__ z, const int* __restrict__ t, const float* __restrict__ f,
    Lists rl, float* __restrict__ out, Dims d, int cc, int cap) {
  extern __shared__ float smem[];
  __shared__ int tile_taps[3];             // first line with taps; lo, hi
  const size_t buf = (size_t)cc * cap * 32;
  float* xs = smem;
  int* tw = reinterpret_cast<int*>(xs + 2 * buf);
  float* fw = reinterpret_cast<float*>(tw + d.W);
  const bool aligned = d.W % 4 == 0 && ((size_t)z & 15) == 0;
  const int warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * kFwdRows, b = blockIdx.y;
  const int rows = min(kFwdRows, d.out - o0);
  const size_t plane = (size_t)d.N * d.W;

  for (int w = threadIdx.x; w < d.W; w += 32 * kFwdRows) {
    tw[w] = norm_shift(t[(size_t)b * d.W + w], d.P);
    fw[w] = f[(size_t)b * d.W + w];
  }
  // this warp's line of the tile, its first 32 taps and the tile's span
  const TileRow tr = tile_row(rl, (size_t)b * d.out + o0, rows, d.P, tile_taps);
  const Line ln{d.P, d.N, d.W, d.W};
  const int o = o0 + min(warp, rows - 1);
  for (int c0 = 0; c0 < d.C; c0 += cc) {
    const int nc = min(cc, d.C - c0);
    float* line = out + ((size_t)(b * d.C + c0) * d.out + o) * d.W;
    pass1_chunks(z + (size_t)(b * d.C + c0) * plane, plane, xs, buf, cap, tr, tw, fw, ln,
                 aligned, nc, 0, (d.W + 31) / 32, line, (size_t)d.out * d.W);
    __syncthreads();                       // the buffers are free for the next channels
  }
}

// grid (ceil(P / 32), B), block (32, kListGroups): the tap lists of M.
__global__ void __launch_bounds__(32 * kListGroups) linepass_lists_kernel(
    const float* __restrict__ M, Lists cl, Dims d) {
  __shared__ int part[kListGroups][32];
  column_lists(M, d.out, d.Pp, d.P, cl, blockIdx.y, part);
}

// grid (ceil(W / kSub), B). Shared: g tile [cc][out][kSub], dv
// [cc][P][kSubStride], the P counts.
__global__ void __launch_bounds__(kBwdThreads) linepass_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ t, const float* __restrict__ f,
    Lists cl, float* __restrict__ dz, Dims d, int cc) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* dv = tile + cc * d.out * kSub;
  int* counts = reinterpret_cast<int*>(dv + cc * d.P * kSubStride);
  const int seg = threadIdx.x / kSub, s = threadIdx.x % kSub;
  const int w0 = blockIdx.x * kSub, b = blockIdx.y;
  const int cols = min(kSub, d.W - w0);
  const int w = w0 + s;
  const bool live = s < cols;
  const int tw = live ? norm_shift(t[(size_t)b * d.W + w], d.P) : 0;
  const float fw = live ? f[(size_t)b * d.W + w] : 0.f;
  const size_t plane = (size_t)d.out * d.W;
  load_counts(cl.cnt + (size_t)b * d.P, d.P, counts);
  for (int c0 = 0; c0 < d.C; c0 += cc) {
    const int nc = min(cc, d.C - c0);
    load_tile(g + (size_t)(b * d.C + c0) * plane + w0, plane, d.W, cols, d.out, nc, tile);
    __syncthreads();
    // dv[j, l, w] = sum_o M[o, l] g[c0+j, o, w]
    gather_taps(tile, counts, cl.idx + (size_t)b * d.P * d.out,
                cl.val + (size_t)b * d.P * d.out, d.P, d.out, nc, dv);
    __syncthreads();
    // dz[i, w]: one segment per (channel, line), lanes over the tile's columns
    if (live) {
      for (int task = seg; task < nc * d.N; task += kSegs) {
        const int j = task / d.N, i = task - j * d.N;
        dz[((size_t)(b * d.C + c0 + j) * d.N + i) * d.W + w] =
            undouble(dv + j * d.P * kSubStride + s, i, tw, fw, d.P, d.N);
      }
    }
    __syncthreads();
  }
}

// How a forward block uses shared memory: the shifts and blends [W] each
// and two staging buffers of cap lines for cc channels ([cc][cap][32]
// each), within the per-block limit less a margin for the kernel's static
// shared memory (tile_taps). cc = 0 if the shifts leave no room.
struct FwdPlan {
  int cc, cap;
  size_t smem;
};

FwdPlan fwd_plan(const Dims& d) {
  const size_t budget = kMaxSmem - 64, shifts = 8 * (size_t)d.W;
  const size_t line = 2 * sizeof(float) * 32;        // a line in both buffers, one channel
  FwdPlan p{d.C < kMaxCc ? d.C : kMaxCc, 0, 0};
  if (shifts + line * p.cc > budget) {
    p.cc = 0;
    return p;
  }
  const size_t cap = (budget - shifts) / (line * p.cc);
  p.cap = (int)(cap < (size_t)2 * d.P ? cap : (size_t)2 * d.P);
  p.smem = shifts + line * p.cc * (size_t)p.cap;
  return p;
}

// Channels a backward block accumulates at once: up to kMaxCc, as many as
// its shared memory allows; 0 if not even one channel fits.
int bwd_channels(const Dims& d) {
  int cc = d.C < kMaxCc ? d.C : kMaxCc;
  while (cc > 0 && bwd_smem(d.P, d.out, cc) > kMaxSmem) --cc;
  return cc;
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
  const int cc = bwd_channels(d) > 0 ? bwd_channels(d) : 1;
  const size_t a = fwd_plan(d).smem, b = bwd_smem(d.P, d.out, cc);
  return a > b ? a : b;
}

// Scratch: the row lists of M (cnt [B,out_len] int32, idx [B,out_len,P]
// int32, val [B,out_len,P] f32).
int ada_linepass_fwd(const void* z, const void* t, const void* f, const void* M, void* out,
                     void* cnt, void* idx, void* val, int B, int C, int N, int W, int P, int Pp,
                     int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, W, P, Pp, out_len);
  cudaStream_t s = (cudaStream_t)stream;
  const FwdPlan p = fwd_plan(d);
  if (p.cc == 0) return (int)cudaErrorInvalidValue;
  const Lists rl{(int*)cnt, (int*)idx, (float*)val};
  linepass_row_lists_kernel<<<dim3((out_len + kListWarps - 1) / kListWarps, B), kListThreads, 0,
                              s>>>((const float*)M, rl, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(linepass_fwd_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  linepass_fwd_kernel<<<dim3((out_len + kFwdRows - 1) / kFwdRows, B), 32 * kFwdRows, p.smem,
                        s>>>((const float*)z, (const int*)t, (const float*)f, rl, (float*)out, d,
                             p.cc, p.cap);
  return (int)cudaGetLastError();
}

// Scratch: the tap lists of M (cnt [B,P] int32, idx [B,P,out_len] int32,
// val [B,P,out_len] f32).
int ada_linepass_bwd(const void* g, const void* t, const void* f, const void* M, void* dz,
                     void* cnt, void* idx, void* val, int B, int C, int N, int W, int P, int Pp,
                     int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, W, P, Pp, out_len);
  cudaStream_t s = (cudaStream_t)stream;
  const int cc = bwd_channels(d);
  if (cc == 0) return (int)cudaErrorInvalidValue;
  const Lists cl{(int*)cnt, (int*)idx, (float*)val};
  linepass_lists_kernel<<<dim3((P + 31) / 32, B), dim3(32, kListGroups), 0, s>>>(
      (const float*)M, cl, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem(P, out_len, cc);
  err = allow_smem(linepass_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  linepass_bwd_kernel<<<dim3((W + kSub - 1) / kSub, B), kBwdThreads, smem, s>>>(
      (const float*)g, (const int*)t, (const float*)f, cl, (float*)dz, d, cc);
  return (int)cudaGetLastError();
}

}  // extern "C"
