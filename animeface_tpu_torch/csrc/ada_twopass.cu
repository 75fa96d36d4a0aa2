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
// it lists the nonzeros of M once per call and sums over those taps only.
// That keeps M a plain input (any M gives the right answer) while the work
// follows the band.
//
// Forward, in two launches:
//   row lists: one pass over M1 and M2, a warp per row (coalesced along
//   it, ballot compaction), writes each row's nonzeros as (column, value)
//   in ascending column order plus a count per row: rcnt [B,R],
//   ridx/rval [B,R,P] (only rcnt entries are written);
//   fused (per tile of kFwdRows rows of y1, all channels): pass 1 into a
//   y1 tile in shared memory from the lists of M1, then pass 2 from the
//   lists of M2 into out.
// A block computes each tap's source rows or columns once for all its
// channels; the TPU kernel also looped over C inside one program. Pass 1
// gathers x along its columns at a shift that changes from column to
// column, so read straight from x a warp's 32 lanes hit about 12 rows
// (main-path draws), a 128-byte line each. The fused kernel therefore
// copies, for each chunk of 32 columns, the window of rows that the
// tile's taps reach into shared memory with whole-line loads and gathers
// there; only a window too large for it (dense M) is read from x through
// L1/L2. No atomics: two calls give bitwise-equal outputs.
//
// Backward (the exact transpose; the gradient goes to x only) runs in
// gather form, without atomics, in three launches:
//   tap lists: one pass over M1 and M2, coalesced along their rows with one
//   lane per column l < P, writes each column's nonzeros as (row, value)
//   in ascending row order plus a count per column: cnt [B,P],
//   idx/val [B,P,R] (R = rows of M; only cnt entries are written);
//   stage A (per tile of kSub rows, all channels): g's tile into shared
//   memory, dv2 = M2^T g from the lists of M2, then the blend and shift
//   transposes and the mirror undoubling of pass 2, giving dy1 [B,C,N,We];
//   stage B (per tile of kSub columns, all channels): the same along the
//   columns, with dy1's tile and the lists of M1, giving dx [B,C,N,Wep]
//   (zero in columns >= We).
// A block reads its image's lists once and sums each tap into every
// channel's accumulator (up to kMaxCc channels a round; the TPU kernel
// looped over C inside one program too). Every output element is one
// thread's sum over its ascending list, so two calls give bitwise-equal dx.
// Bytes: the chain must read g, M1 and M2 and write dx (the same 105 MB as
// the forward); it moves M once, the lists (13 taps a row of M, 3.4 MB),
// g once, dy1 twice and dx once, about 184 MB. What bounds it at the main
// path's shapes is instruction issue in the gathers (a tap costs two
// shuffles and a shared-memory load per channel), not bytes.
//
// The list builders, the gathers and the window staging are in
// ada_warp_common.cuh, shared with ada_linepass.cu; pass 2 of the forward
// and the backward's stage A are this file's own.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError().

#include "ada_warp_common.cuh"

namespace {

using namespace ada_warp;

constexpr int kThreads = 256;             // the forward's row-list kernel
constexpr int kWarps = kThreads / 32;

struct Dims {
  int B, C, N, Wep, We, P1, P1p, P2, P2p, out;
};

// ---------------------------------------------------------------- backward

// grid (ceil(max(P1, P2) / 32), B, 2): z = 0 lists M1's columns (R = N
// rows), z = 1 M2's (R = out). block (32, kListGroups): `column_lists`.
__global__ void __launch_bounds__(32 * kListGroups) twopass_lists_kernel(
    const float* __restrict__ M1, const float* __restrict__ M2, Lists l1, Lists l2, Dims d) {
  __shared__ int part[kListGroups][32];
  const bool second = blockIdx.z != 0;
  column_lists(second ? M2 : M1, second ? d.out : d.N, second ? d.P2p : d.P1p,
               second ? d.P2 : d.P1, second ? l2 : l1, blockIdx.y, part);
}

// Stage A. grid (ceil(N / kSub), B). Shared: g tile [cc][out][kSub], dv2
// [cc][P2][kSubStride], M2's counts [P2].
__global__ void __launch_bounds__(kBwdThreads) twopass_bwd_rows_kernel(
    const float* __restrict__ g, const int* __restrict__ t2, const float* __restrict__ f2,
    Lists l2, float* __restrict__ dy1, Dims d, int cc) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* dv = tile + cc * d.out * kSub;
  int* counts = reinterpret_cast<int*>(dv + cc * d.P2 * kSubStride);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kSub, b = blockIdx.y;
  const int rows = min(kSub, d.N - r0);
  const size_t plane = (size_t)d.out * d.N;
  load_counts(l2.cnt + (size_t)b * d.P2, d.P2, counts);
  for (int c0 = 0; c0 < d.C; c0 += cc) {
    const int nc = min(cc, d.C - c0);
    load_tile(g + (size_t)(b * d.C + c0) * plane + r0, plane, d.N, rows, d.out, nc, tile);
    __syncthreads();
    // dv2[j, l, r] = sum_o M2[o, l] g[c0+j, o, r]
    gather_taps(tile, counts, l2.idx + (size_t)b * d.P2 * d.out,
                l2.val + (size_t)b * d.P2 * d.out, d.P2, d.out, nc, dv);
    __syncthreads();
    // dy1[r, w]: one warp per (channel, row), lanes over w
    for (int task = warp; task < nc * rows; task += kBwdWarps) {
      const int j = task / rows, rr = task - j * rows, r = r0 + rr;
      const int t = norm_shift(t2[(size_t)b * d.N + r], d.P2);
      const float f = f2[(size_t)b * d.N + r];
      const float* dvr = dv + j * d.P2 * kSubStride + rr;
      float* dyr = dy1 + ((size_t)(b * d.C + c0 + j) * d.N + r) * d.We;
      for (int w = lane; w < d.We; w += 32) dyr[w] = undouble(dvr, w, t, f, d.P2, d.We);
    }
    __syncthreads();
  }
}

// Stage B. grid (ceil(Wep / kSub), B). Shared: dy1 tile [cc][N][kSub], dv1
// [cc][P1][kSubStride], M1's counts [P1].
__global__ void __launch_bounds__(kBwdThreads) twopass_bwd_cols_kernel(
    const float* __restrict__ dy1, const int* __restrict__ t1, const float* __restrict__ f1,
    Lists l1, float* __restrict__ dx, Dims d, int cc) {
  extern __shared__ float smem[];
  float* tile = smem;
  float* dv = tile + cc * d.N * kSub;
  int* counts = reinterpret_cast<int*>(dv + cc * d.P1 * kSubStride);
  const int seg = threadIdx.x / kSub, s = threadIdx.x % kSub;
  const int w0 = blockIdx.x * kSub, b = blockIdx.y;
  const int cols = min(kSub, d.We - w0);     // live columns; <= 0 in the padding
  const int w = w0 + s;
  const bool live = s < cols;
  const int t = live ? norm_shift(t1[(size_t)b * d.Wep + w], d.P1) : 0;
  const float f = live ? f1[(size_t)b * d.Wep + w] : 0.f;
  const size_t plane = (size_t)d.N * d.We;
  if (cols > 0) load_counts(l1.cnt + (size_t)b * d.P1, d.P1, counts);
  for (int c0 = 0; c0 < d.C; c0 += cc) {
    const int nc = min(cc, d.C - c0);
    if (cols > 0) {
      load_tile(dy1 + (size_t)(b * d.C + c0) * plane + w0, plane, d.We, cols, d.N, nc, tile);
      __syncthreads();
      // dv1[j, l, w] = sum_r M1[r, l] dy1[c0+j, r, w]
      gather_taps(tile, counts, l1.idx + (size_t)b * d.P1 * d.N,
                  l1.val + (size_t)b * d.P1 * d.N, d.P1, d.N, nc, dv);
    }
    __syncthreads();
    // dx[i, w]: one segment per (channel, row), lanes over the tile's columns
    if (w < d.Wep) {
      for (int task = seg; task < nc * d.N; task += kSegs) {
        const int j = task / d.N, i = task - j * d.N;
        dx[((size_t)(b * d.C + c0 + j) * d.N + i) * d.Wep + w] =
            live ? undouble(dv + j * d.P1 * kSubStride + s, i, t, f, d.P1, d.N) : 0.f;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward

// Row lists, the forward's: row r of image b holds cnt[b*R + r] taps at
// idx/val[(b*R + r)*P + k], k ascending with the column l < P (R = rows
// of M). grid (ceil(max(N, out) / kWarps), B, 2): z = 0 lists M1's rows,
// z = 1 M2's; one warp a row, coalesced along it (compact_row).
__global__ void __launch_bounds__(kThreads) twopass_row_lists_kernel(
    const float* __restrict__ M1, const float* __restrict__ M2, Lists l1, Lists l2, Dims d) {
  const bool second = blockIdx.z != 0;
  const int R = second ? d.out : d.N;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (r >= R) return;                      // the whole warp: compact_row is warp-collective
  const int P = second ? d.P2 : d.P1;
  const Lists out = second ? l2 : l1;
  const size_t row = (size_t)b * R + r;
  const int n = compact_row((second ? M2 : M1) + row * (second ? d.P2p : d.P1p), P,
                            out.idx + row * P, out.val + row * P);
  if ((threadIdx.x & 31) == 0) out.cnt[row] = n;
}

// Both passes for a tile of kFwdRows rows of y1 and all channels (cc a
// round). grid (ceil(N / kFwdRows), B), 32 * kFwdRows threads. Shared: the
// y1 tile [cc][kFwdRows][We+1], two staging buffers [cc][cap][32], and the
// shifts and blends of pass 1 [We] each.
//   pass 1, a warp per row of the tile (its list's first 32 taps kept in
//   registers), per chunk of 32 columns: the rows of the doubled canvas
//   that the tile's taps reach in these columns form one cyclic window
//   (the tile's taps, unwrapped around one of them, span [lo, hi]; the
//   chunk's shifts, unwrapped around the first column's, span [dmin,
//   dmax]). If it fits in cap rows, the block copies it from x into shared
//   memory with cp.async, each row's 32 columns in one 128-byte load, the
//   next chunk's while this one is summed, and the gathers read it there
//   (lane = column: no bank conflicts whatever the shifts); otherwise
//   (dense M, say) they read x through L1/L2;
//   pass 2: a warp per output line o, a lane per row of the tile, taps
//   from row o's list of M2 (the next line's first taps load while this
//   one sums).
// Every output element is one thread's sum over its row's ascending list:
// no atomics.
__global__ void __launch_bounds__(32 * kFwdRows) twopass_fwd_kernel(
    const float* __restrict__ x, const int* __restrict__ t1, const float* __restrict__ f1,
    const int* __restrict__ t2, const float* __restrict__ f2, Lists l1, Lists l2,
    float* __restrict__ out, Dims d, int cc, int cap) {
  extern __shared__ float smem[];
  __shared__ int tile_taps[3];             // first row with taps; lo, hi
  const int ys = d.We + 1;
  const size_t buf = (size_t)cc * cap * 32;
  float* y1 = smem;
  float* xs = y1 + (size_t)cc * kFwdRows * ys;  // 16-byte aligned: kFwdRows is a multiple of 4
  int* tw = reinterpret_cast<int*>(xs + 2 * buf);
  float* fw = reinterpret_cast<float*>(tw + d.We);
  const bool aligned = d.Wep % 4 == 0 && ((size_t)x & 15) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kFwdRows, b = blockIdx.y;
  const int rows = min(kFwdRows, d.N - r0);
  const size_t plane = (size_t)d.N * d.Wep, row0 = (size_t)b * d.N + r0;

  for (int w = threadIdx.x; w < d.We; w += 32 * kFwdRows) {
    tw[w] = norm_shift(t1[(size_t)b * d.Wep + w], d.P1);
    fw[w] = f1[(size_t)b * d.Wep + w];
  }
  // this warp's row of the tile, its first 32 taps and the tile's span
  const TileRow tr = tile_row(l1, row0, rows, d.P1, tile_taps);
  const Line ln{d.P1, d.N, d.Wep, d.We};

  const int r2 = r0 + min(lane, rows - 1);            // pass 2: row r0 + lane
  const int t2r = norm_shift(t2[(size_t)b * d.N + r2], d.P2);
  const float f2r = f2[(size_t)b * d.N + r2];
  const int n_chunks = (d.We + 31) / 32;

  for (int c0 = 0; c0 < d.C; c0 += cc) {
    const int nc = min(cc, d.C - c0);
    const float* xb = x + (size_t)(b * d.C + c0) * plane;
    pass1_chunks(xb, plane, xs, buf, cap, tr, tw, fw, ln, aligned, nc, 0, n_chunks,
                 y1 + (size_t)warp * ys, (size_t)kFwdRows * ys);
    __syncthreads();
    // pass 2: out[c0+j][o][r] = sum_k val[k] ((1-f2) y1[r][mir(j0)] + f2 y1[r][mir(j1)])
    const float* yr = y1 + (size_t)lane * ys;
    int o_nx = warp;
    size_t line_nx = (size_t)b * d.out + min(o_nx, d.out - 1);
    int n_nx = o_nx < d.out ? l2.cnt[line_nx] : 0;
    int i_nx = lane < d.P2 ? l2.idx[line_nx * d.P2 + lane] : 0;       // past the count: never used
    float m_nx = lane < d.P2 ? l2.val[line_nx * d.P2 + lane] : 0.f;
    for (int o = warp; o < d.out; o += kFwdRows) {
      const int n2 = n_nx, i_first = i_nx;
      const float m_first = m_nx;
      const size_t line = line_nx;
      o_nx = o + kFwdRows;                     // the next line's count and first taps
      line_nx = (size_t)b * d.out + min(o_nx, d.out - 1);
      n_nx = o_nx < d.out ? l2.cnt[line_nx] : 0;
      i_nx = lane < d.P2 ? l2.idx[line_nx * d.P2 + lane] : 0;
      m_nx = lane < d.P2 ? l2.val[line_nx * d.P2 + lane] : 0.f;
      const int* il2 = l2.idx + line * d.P2;
      const float* vl2 = l2.val + line * d.P2;
      float acc[kMaxCc] = {}, e[kMaxCc] = {};
      int prev = -2;
      for (int k0 = 0; k0 < n2; k0 += 32) {
        const int li = k0 == 0 ? i_first : (k0 + lane < n2 ? il2[k0 + lane] : 0);
        const float mi = k0 == 0 ? m_first : (k0 + lane < n2 ? vl2[k0 + lane] : 0.f);
        const int kk = min(32, n2 - k0);
#pragma unroll 4
        for (int q = 0; q < kk; ++q) {
          const int i = __shfl_sync(0xffffffffu, li, q);
          const float m = __shfl_sync(0xffffffffu, mi, q);
          const bool next = i == prev + 1;
          prev = i;
          const int j0 = wrap_up(i + t2r, d.P2);
          const int wa = mirror(j0, d.We), wb = mirror(wrap_up(j0 + 1, d.P2), d.We);
#pragma unroll
          for (int j = 0; j < kMaxCc; ++j) {
            if (j < nc) {
              const float* yj = yr + (size_t)j * kFwdRows * ys;
              const float a = next ? e[j] : yj[wa];
              e[j] = yj[wb];
              acc[j] = fmaf(m, (1.f - f2r) * a + f2r * e[j], acc[j]);
            }
          }
        }
      }
      if (lane < rows) {
#pragma unroll
        for (int j = 0; j < kMaxCc; ++j)
          if (j < nc) out[((size_t)(b * d.C + c0 + j) * d.out + o) * d.N + r0 + lane] = acc[j];
      }
    }
    __syncthreads();
  }
}

// How a forward block uses shared memory: cc channels a round (the y1
// tile [cc][kFwdRows][We+1]), the shifts and blends [We] each, and two
// staging buffers of cap rows ([cc][cap][32] each), within the per-block
// limit less a margin for the kernel's static shared memory (tile_taps).
// cc = 0 if not even one channel's tile fits.
struct FwdPlan {
  int cc, cap;
  size_t smem;
};

FwdPlan fwd_plan(const Dims& d) {
  const size_t budget = kMaxSmem - 64;
  const size_t tile = sizeof(float) * (size_t)kFwdRows * (d.We + 1), shifts = 8 * (size_t)d.We;
  FwdPlan p{d.C < kMaxCc ? d.C : kMaxCc, 0, 0};
  while (p.cc > 0 && p.cc * tile + shifts > budget) --p.cc;
  if (p.cc == 0) return p;
  const size_t cap = (budget - p.cc * tile - shifts) / (2 * sizeof(float) * 32 * p.cc);
  p.cap = (int)(cap < (size_t)2 * d.P1 ? cap : (size_t)2 * d.P1);
  p.smem = p.cc * tile + shifts + 2 * sizeof(float) * 32 * p.cc * (size_t)p.cap;
  return p;
}

// Channels a backward block accumulates at once: up to kMaxCc, as many as
// both stages' shared memory allows; 0 if not even one channel fits.
int bwd_channels(const Dims& d) {
  int cc = d.C < kMaxCc ? d.C : kMaxCc;
  while (cc > 0 && (bwd_smem(d.P2, d.out, cc) > kMaxSmem || bwd_smem(d.P1, d.N, cc) > kMaxSmem))
    --cc;
  return cc;
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
  const int cc = bwd_channels(d) > 0 ? bwd_channels(d) : 1;
  size_t m = fwd_plan(d).smem;
  if (bwd_smem(d.P2, d.out, cc) > m) m = bwd_smem(d.P2, d.out, cc);
  if (bwd_smem(d.P1, d.N, cc) > m) m = bwd_smem(d.P1, d.N, cc);
  return m;
}

// Scratch: the row lists of M1 (rcnt1 [B,N] int32, ridx1 [B,N,P1] int32,
// rval1 [B,N,P1] f32) and of M2 (rcnt2 [B,out_len], ridx2 and rval2
// [B,out_len,P2]).
int ada_twopass_fwd(const void* x, const void* t1, const void* f1, const void* M1,
                    const void* t2, const void* f2, const void* M2, void* out,
                    void* rcnt1, void* ridx1, void* rval1, void* rcnt2, void* ridx2,
                    void* rval2, int B, int C, int N, int Wep, int We, int P1, int P1p, int P2,
                    int P2p, int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, Wep, We, P1, P1p, P2, P2p, out_len);
  cudaStream_t s = (cudaStream_t)stream;
  const FwdPlan p = fwd_plan(d);
  if (p.cc == 0) return (int)cudaErrorInvalidValue;
  const Lists l1{(int*)rcnt1, (int*)ridx1, (float*)rval1};
  const Lists l2{(int*)rcnt2, (int*)ridx2, (float*)rval2};
  const int R = N > out_len ? N : out_len;
  twopass_row_lists_kernel<<<dim3((R + kWarps - 1) / kWarps, B, 2), kThreads, 0, s>>>(
      (const float*)M1, (const float*)M2, l1, l2, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(twopass_fwd_kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  twopass_fwd_kernel<<<dim3((N + kFwdRows - 1) / kFwdRows, B), 32 * kFwdRows, p.smem, s>>>(
      (const float*)x, (const int*)t1, (const float*)f1, (const int*)t2, (const float*)f2, l1,
      l2, (float*)out, d, p.cc, p.cap);
  return (int)cudaGetLastError();
}

// Scratch: dy1 [B,C,N,We] f32; the tap lists of M1 (cnt1 [B,P1] int32,
// idx1 [B,P1,N] int32, val1 [B,P1,N] f32) and of M2 (cnt2 [B,P2], idx2 and
// val2 [B,P2,out_len]).
int ada_twopass_bwd(const void* g, const void* t1, const void* f1, const void* M1,
                    const void* t2, const void* f2, const void* M2, void* dx, void* dy1,
                    void* cnt1, void* idx1, void* val1, void* cnt2, void* idx2, void* val2,
                    int B, int C, int N, int Wep, int We, int P1, int P1p, int P2, int P2p,
                    int out_len, void* stream) {
  const Dims d = make_dims(B, C, N, Wep, We, P1, P1p, P2, P2p, out_len);
  cudaStream_t s = (cudaStream_t)stream;
  const int cc = bwd_channels(d);
  if (cc == 0) return (int)cudaErrorInvalidValue;
  const Lists l1{(int*)cnt1, (int*)idx1, (float*)val1};
  const Lists l2{(int*)cnt2, (int*)idx2, (float*)val2};
  const int P = P1 > P2 ? P1 : P2;
  twopass_lists_kernel<<<dim3((P + 31) / 32, B, 2), dim3(32, kListGroups), 0, s>>>(
      (const float*)M1, (const float*)M2, l1, l2, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  size_t smem = bwd_smem(P2, out_len, cc);
  err = allow_smem(twopass_bwd_rows_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  twopass_bwd_rows_kernel<<<dim3((N + kSub - 1) / kSub, B), kBwdThreads, smem, s>>>(
      (const float*)g, (const int*)t2, (const float*)f2, l2, (float*)dy1, d, cc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  smem = bwd_smem(P1, N, cc);
  err = allow_smem(twopass_bwd_cols_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  twopass_bwd_cols_kernel<<<dim3((Wep + kSub - 1) / kSub, B), kBwdThreads, smem, s>>>(
      (const float*)dy1, (const int*)t1, (const float*)f1, l1, (float*)dx, d, cc);
  return (int)cudaGetLastError();
}

}  // extern "C"
