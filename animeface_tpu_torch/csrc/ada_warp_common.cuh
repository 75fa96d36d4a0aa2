// Device code shared by the ADA warp's kernels for Hopper (sm_90a):
// ada_twopass.cu (both passes in one call) and ada_linepass.cu (one line
// pass a call). Each source includes it and builds into its own library.
//
// Along one axis of the warp, N lines are read through the pixel-centre
// mirror extension, one period of which has P = 2N - 2 lines:
// mir_N(j) = j < N ? j : 2N-2-j. A kernel matrix M [R, Pp] (columns >= P
// ignored) is banded, so the kernels never multiply its zeros: they list
// its nonzeros once per call and sum over those taps only.
//
//   lists: compact_row (a warp per row of M: the forward's row lists) and
//   column_lists (a lane per column: the backward's tap lists), in one
//   format (`Lists`), entries ascending;
//   backward gathers, all channels of a tile of kSub lines in one block:
//   load_tile, load_counts, gather_taps (dv = M^T g from the tap lists)
//   and undouble (the transposes of the blend, the shift and the mirror
//   doubling);
//   forward gathers along lines whose shift changes from column to
//   column, a warp per row of M in a tile of kFwdRows rows: tile_row (the
//   warp's first taps and the tile's span), then per chunk of 32 columns
//   chunk_window, stage_window (the window of lines the tile's taps reach,
//   copied into shared memory with cp.async) and pass1_row, driven by
//   pass1_chunks.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ada_warp {

constexpr size_t kMaxSmem = 232448;       // per-block dynamic shared memory on sm_90

__device__ __forceinline__ int mirror(int j, int n) { return j < n ? j : 2 * n - 2 - j; }

__device__ __forceinline__ int wrap_up(int j, int p) { return j >= p ? j - p : j; }

__device__ __forceinline__ int wrap_down(int j, int p) { return j < 0 ? j + p : j; }

__device__ __forceinline__ int norm_shift(int t, int p) {
  t %= p;
  return t < 0 ? t + p : t;
}

// One list set. Row lists (the forward's): row r of image b holds
// cnt[b*R + r] taps at idx/val[(b*R + r)*P + k], k ascending with the
// column l < P. Tap lists (the backward's): column l holds cnt[b*P + l]
// taps at idx/val[(b*P + l)*R + k], k ascending with the row. Entries past
// a count are not written.
struct Lists {
  int* cnt;
  int* idx;
  float* val;
};

// ---------------------------------------------------------------- lists

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

constexpr int kListGroups = 8;            // row groups per column in the tap-list builder

// The tap lists of M [B, R, Pp] (image b's, columns l < P), for a block
// (32, kListGroups) whose lane x is column blockIdx.x * 32 + x: row group
// y counts, then writes, the nonzeros of rows [y*span, (y+1)*span) after
// those of the groups above it (part: the block's [kListGroups][32]
// counts in shared memory). The second read of the rows hits L1 (a block
// spans 32 columns of R rows).
__device__ void column_lists(const float* __restrict__ M, int R, int Pp, int P, Lists out,
                             int b, int (*part)[32]) {
  if ((int)blockIdx.x * 32 >= P) return;   // the whole block: before any barrier
  const int l = blockIdx.x * 32 + threadIdx.x;
  const bool live = l < P;
  const int span = (R + kListGroups - 1) / kListGroups;
  const int r0 = threadIdx.y * span, r1 = min(R, r0 + span);
  const float* col = M + (size_t)b * R * Pp + l;

  int n = 0;
  if (live) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r) n += __ldg(col + (size_t)r * Pp) != 0.f;
  }
  part[threadIdx.y][threadIdx.x] = n;
  __syncthreads();
  if (!live) return;
  int k = 0;
  for (int j = 0; j < (int)threadIdx.y; ++j) k += part[j][threadIdx.x];
  if (threadIdx.y == kListGroups - 1) out.cnt[(size_t)b * P + l] = k + n;
  int* idx = out.idx + ((size_t)b * P + l) * R;
  float* val = out.val + ((size_t)b * P + l) * R;
  for (int r = r0; r < r1; ++r) {
    const float m = __ldg(col + (size_t)r * Pp);
    if (m != 0.f) {
      idx[k] = r;
      val[k] = m;
      ++k;
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSub = 8;                   // lines of the output a block takes
constexpr int kSegs = kBwdThreads / kSub; // segments of kSub lanes (the output phases)
constexpr int kVec = 4;                   // lines a lane sums in the gather (a float4)
constexpr int kLanes = kSub / kVec;       // lanes a column of M takes in the gather
constexpr int kStep = 8;                  // taps a column loads at once, kStep / kLanes a lane
static_assert(kVec == 4 && kSub % kVec == 0 && 32 % kLanes == 0 && kStep % kLanes == 0,
              "tile shapes");
constexpr int kSubStride = kSub + 1;      // dv's column stride, odd so lanes spread over banks
constexpr int kMaxCc = 4;                 // channels accumulated at once

// Copies the tile z_j[r*stride + s], j < cc, r < R, s < kSub (zero for
// s >= live) of the cc channels of z (channel stride cstride) into
// tile [cc][R][kSub]: every element of z is read from memory once, and the
// gather below reads it from shared memory once for each tap of its row.
// 16-byte loads where the tile is whole and aligned.
__device__ void load_tile(const float* __restrict__ z, size_t cstride, int stride, int live,
                          int R, int cc, float* tile) {
  constexpr int kV = kSub / 4;
  if (live == kSub && stride % 4 == 0 && cstride % 4 == 0 && ((size_t)z & 15) == 0) {
    float4* t4 = reinterpret_cast<float4*>(tile);
    const int n = cc * R * kV;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += kBwdThreads) {
      const int v = e % kV, r = (e / kV) % R, j = e / (kV * R);
      t4[e] = __ldg(reinterpret_cast<const float4*>(z + j * cstride + (size_t)r * stride) + v);
    }
    return;
  }
  const int n = cc * R * kSub;
  for (int e = threadIdx.x; e < n; e += kBwdThreads) {
    const int s = e % kSub, r = (e / kSub) % R, j = e / (kSub * R);
    tile[e] = s < live ? z[j * cstride + (size_t)r * stride + s] : 0.f;
  }
}

// dv[j][l][s] = sum_k val[l,k] tile[j][idx[l,k]][s] for the cc channels j
// and the tile's lines s, with cnt (the P counts) in shared memory. A warp
// takes 32 / kLanes neighbouring columns of M at once, kLanes lanes each
// (a lane sums kVec lines s), and steps through their taps together up to
// the largest count among them, so that its shuffles never diverge: the
// lanes of a column load kStep of its taps at once and pass them round by
// shuffles, and each tap's kVec lines of the tile are one 16-byte load. A
// tap past a column's count adds nothing.
__device__ void gather_taps(const float* tile, const int* cnt, const int* __restrict__ idx,
                            const float* __restrict__ val, int P, int R, int cc, float* dv) {
  constexpr int kCols = 32 / kLanes, kPerLane = kStep / kLanes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / kLanes, s = lane % kLanes;
  const float* ts = tile + kVec * s;
  for (int l0 = warp * kCols; l0 < P; l0 += kBwdWarps * kCols) {
    const int l = l0 + seg;
    const int n = l < P ? cnt[l] : 0;
    int most = n;
#pragma unroll
    for (int o = 16; o >= kLanes; o >>= 1) most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
    const int* il = idx + (size_t)l * R;
    const float* vl = val + (size_t)l * R;
    float4 acc[kMaxCc] = {};
    for (int k0 = 0; k0 < most; k0 += kStep) {
      int r[kPerLane];
      float m[kPerLane];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int k = k0 + u * kLanes + s;
        r[u] = k < n ? il[k] * kSub : 0;
        m[u] = k < n ? vl[k] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kStep; ++q) {
        const int rq = __shfl_sync(0xffffffffu, r[q / kLanes], q % kLanes, kLanes);
        const float mq = __shfl_sync(0xffffffffu, m[q / kLanes], q % kLanes, kLanes);
        if (k0 + q < n) {
#pragma unroll
          for (int j = 0; j < kMaxCc; ++j) {
            if (j < cc) {
              const float4 x = *reinterpret_cast<const float4*>(ts + rq + j * R * kSub);
              acc[j].x = fmaf(mq, x.x, acc[j].x);
              acc[j].y = fmaf(mq, x.y, acc[j].y);
              acc[j].z = fmaf(mq, x.z, acc[j].z);
              acc[j].w = fmaf(mq, x.w, acc[j].w);
            }
          }
        }
      }
    }
    if (l < P) {
#pragma unroll
      for (int j = 0; j < kMaxCc; ++j) {
        if (j < cc) {
          float* out = dv + (j * P + l) * kSubStride + kVec * s;
          out[0] = acc[j].x;
          out[1] = acc[j].y;
          out[2] = acc[j].z;
          out[3] = acc[j].w;
        }
      }
    }
  }
}

// The P counts of one list set into shared memory.
__device__ void load_counts(const int* __restrict__ cnt, int P, int* out) {
  for (int l = threadIdx.x; l < P; l += kBwdThreads) out[l] = cnt[l];
}

// Transpose of the blend, the shift and the mirror doubling along one
// line, at output position i < n: dz(m) = (1-f) dv[(m-t) mod P] +
// f dv[(m-t-1) mod P]; the result is dz(i) + dz(P-i) for 0 < i < n-1,
// else dz(i). dv points at the line's entry of column 0 (column stride
// kSubStride).
__device__ __forceinline__ float undouble(const float* dv, int i, int t, float f, int P, int n) {
  int i0 = wrap_down(i - t, P);
  int i1 = wrap_down(i0 - 1, P);
  float s = (1.f - f) * dv[i0 * kSubStride] + f * dv[i1 * kSubStride];
  if (i > 0 && i < n - 1) {
    i0 = wrap_down(P - i - t, P);
    i1 = wrap_down(i0 - 1, P);
    s += (1.f - f) * dv[i0 * kSubStride] + f * dv[i1 * kSubStride];
  }
  return s;
}

// A backward block's shared memory: the tile [cc][R][kSub], dv
// [cc][P][kSubStride] and the P counts.
inline size_t bwd_smem(int P, int R, int cc) {
  return sizeof(float) * ((size_t)cc * ((size_t)R * kSub + (size_t)P * kSubStride) + P);
}

// ---------------------------------------------------------------- forward

constexpr int kFwdRows = 32;              // rows of M a forward block takes, a warp each

// The gathered axis: P = 2N - 2 lines of the mirror extension of N
// lines, `stride` apart in the source, whose rows hold `live` columns.
struct Line {
  int P, N, stride, live;
};

// l unwrapped around lref on a cycle of P: lref + u, |u| <= P / 2.
__device__ __forceinline__ int unwrap(int l, int lref, int P) {
  const int u = l - lref, half = P / 2;
  return u > half ? u - P : (u < -half ? u + P : u);
}

// A warp's row of a forward tile: its count and list, its first 32 taps
// (l_lane, m_lane; u_lane is l_lane unwrapped around lref), and the
// tile's taps, unwrapped around lref (the first tap of the tile's first
// row with taps), spanning [lo, hi] (lo > hi: the tile has no taps).
struct TileRow {
  bool has_row;
  int n;
  const int* il;
  const float* vl;
  int l_lane, u_lane;
  float m_lane;
  int lref, lo, hi;
};

// Block-collective (it holds barriers): warp w takes row row0 + w of the
// row lists `rl` of a matrix with P columns, for the tile's `rows` rows;
// tile_taps: 3 ints of static shared memory.
__device__ TileRow tile_row(const Lists& rl, size_t row0, int rows, int P, int* tile_taps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TileRow tr;
  tr.has_row = warp < rows;
  const size_t row = row0 + min(warp, rows - 1);
  tr.n = tr.has_row ? rl.cnt[row] : 0;
  tr.il = rl.idx + row * P;
  tr.vl = rl.val + row * P;
  tr.l_lane = lane < tr.n ? tr.il[lane] : 0;
  tr.m_lane = lane < tr.n ? tr.vl[lane] : 0.f;
  if (threadIdx.x == 0) {
    tile_taps[0] = kFwdRows;
    tile_taps[1] = 0x7fffffff;
    tile_taps[2] = -0x7fffffff;
  }
  __syncthreads();
  if (lane == 0 && tr.n > 0) atomicMin(&tile_taps[0], warp);
  __syncthreads();
  tr.lref = tile_taps[0] < rows ? rl.idx[(row0 + tile_taps[0]) * P] : 0;
  {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int k = lane; k < tr.n; k += 32) {
      const int u = unwrap(k < 32 ? tr.l_lane : tr.il[k], tr.lref, P);
      lo = min(lo, u);
      hi = max(hi, u);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0 && tr.n > 0) {
      atomicMin(&tile_taps[1], lo);
      atomicMax(&tile_taps[2], hi);
    }
  }
  __syncthreads();
  tr.lo = tile_taps[1];
  tr.hi = tile_taps[2];
  tr.u_lane = unwrap(tr.l_lane, tr.lref, P);
  return tr;
}

// A chunk's window: the len lines of the doubled canvas from jlo (mod P)
// that the tile's taps reach in 32 columns w0 + lane. A tap at column l,
// unwrapped around lref to lref + u, reads lines u + base and u + base + 1
// of it (base: the lane's own).
struct Window {
  int jlo, len, base;
};

// Warp-collective. tw: the live columns' shifts t mod P; wc: the lane's
// column, clamped to a live one; the tile's taps span [lo, hi] around lref.
__device__ Window chunk_window(const int* tw, int w0, int wc, int lref, int lo, int hi, int P) {
  const int tref = tw[w0];
  const int dl = unwrap(tw[wc], tref, P);           // the shift around the chunk's first
  int dmin = dl, dmax = dl;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dmin = min(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
    dmax = max(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
  }
  Window win;
  win.len = lo <= hi ? hi - lo + dmax - dmin + 2 : 0;
  win.jlo = lref + lo + tref + dmin;
  win.base = dl - dmin - lo;
  return win;
}

// Starts copying a window of the nc channels of x (channel stride plane)
// into xs [cc][cap][32] with cp.async, kFwdRows warps. vec (the chunk's 32
// columns lie inside x's rows, 16-byte aligned): a warp copies four
// 128-byte rows per instruction, 16 bytes a lane; else one row, 4 bytes a
// lane (columns clamped to live ones).
__device__ void stage_window(const float* __restrict__ xb, size_t plane, const Window& win,
                             int w0, int wc, bool vec, int nc, int cap, const Line& ln,
                             float* xs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_at_once = vec ? 4 : 1;
  const int sub = vec ? lane >> 3 : 0, col = vec ? 4 * (lane & 7) : lane;
  const float* src = xb + (vec ? w0 + col : wc);
  const int step = rows_at_once * kFwdRows;
  const int jj0 = norm_shift(win.jlo + rows_at_once * warp + sub, ln.P);
  for (int j = 0; j < nc; ++j) {
    int jj = jj0;                          // line jlo + i of the doubled canvas, mod P
    for (int i = rows_at_once * warp + sub; i < win.len; i += step) {
      float* dst = xs + ((size_t)j * cap + i) * 32 + col;
      const float* row = src + j * plane + (size_t)mirror(jj, ln.N) * ln.stride;
      if (vec)
        __pipeline_memcpy_async(dst, row, 16);
      else
        __pipeline_memcpy_async(dst, row, sizeof(float));
      jj += step;
      while (jj >= ln.P) jj -= ln.P;
    }
  }
}

// One row of M in one chunk (lane = column w; wc = w clamped to a live
// column): y1r[j][w] = sum_k val[k] ((1-f) x[mir(j0), w] + f x[mir(j1), w]),
// j0 = (l_k + t) mod P, j1 = (j0 + 1) mod P, over the row's n taps in
// ascending order, passed round by shuffles (the first 32 come in
// (v_lane, m_lane): l, or for kStaged its unwrapped u). kStaged: the
// sources come from the staged window xs [cc][cap][32]; else from x
// through L1/L2. Where a tap's first source is the last tap's second, it
// is taken from registers. y1r's channels are y1_cs apart.
template <bool kStaged>
__device__ void pass1_row(const float* __restrict__ xb, size_t plane, const float* xs, int cap,
                          const int* __restrict__ il, const float* __restrict__ vl, int n,
                          int v_lane, float m_lane, const Line& ln, int w, int wc, int t, float f,
                          int base, int lref, int nc, float* y1r, size_t y1_cs) {
  const int lane = threadIdx.x & 31;
  const size_t cs = kStaged ? (size_t)cap * 32 : plane;      // channel stride of the source
  float acc[kMaxCc] = {}, e[kMaxCc] = {};
  int p1_prev = -1;
  for (int k0 = 0; k0 < n; k0 += 32) {
    int vi = v_lane;
    float mi = m_lane;
    if (k0 > 0) {
      vi = k0 + lane < n ? il[k0 + lane] : 0;
      vi = kStaged ? unwrap(vi, lref, ln.P) : vi;
      mi = k0 + lane < n ? vl[k0 + lane] : 0.f;
    }
    const int kk = min(32, n - k0);
#pragma unroll 4
    for (int q = 0; q < kk; ++q) {
      const int v = __shfl_sync(0xffffffffu, vi, q);
      const float m = __shfl_sync(0xffffffffu, mi, q);
      const int p0 = kStaged ? v + base : wrap_up(v + t, ln.P);
      const int p1 = kStaged ? p0 + 1 : wrap_up(p0 + 1, ln.P);
      const bool next = p0 == p1_prev;
      p1_prev = p1;
      const float* s0 = kStaged ? xs + p0 * 32 + lane : xb + (size_t)mirror(p0, ln.N) * ln.stride + wc;
      const float* s1 = kStaged ? xs + p1 * 32 + lane : xb + (size_t)mirror(p1, ln.N) * ln.stride + wc;
#pragma unroll
      for (int j = 0; j < kMaxCc; ++j) {
        if (j < nc) {
          const float a = next ? e[j] : s0[j * cs];
          e[j] = s1[j * cs];
          acc[j] = fmaf(m, (1.f - f) * a + f * e[j], acc[j]);
        }
      }
    }
  }
  if (w < ln.live) {
#pragma unroll
    for (int j = 0; j < kMaxCc; ++j)
      if (j < nc) y1r[j * y1_cs + w] = acc[j];
  }
}

// Block-collective: the warp's row `tr` of M over chunks [ci0, ci1) of 32
// columns of the nc channels of x, into y1r (channels y1_cs apart). Per
// chunk, the lines that the tile's taps reach in its columns form one
// cyclic window; if it fits in cap lines, the block copies it from x into
// one of the two staging buffers xs [cc][cap][32] (buf floats apart) with
// cp.async, the next chunk's while this one is summed, and the gathers
// read it there (lane = column: no bank conflicts whatever the shifts);
// otherwise (dense M, say) they read x through L1/L2. tw/fw: the live
// columns' shifts mod P and blends, in shared memory. The caller
// synchronises before the buffers are used again.
__device__ void pass1_chunks(const float* __restrict__ xb, size_t plane, float* xs, size_t buf,
                             int cap, const TileRow& tr, const int* tw, const float* fw,
                             const Line& ln, bool aligned, int nc, int ci0, int ci1, float* y1r,
                             size_t y1_cs) {
  const int lane = threadIdx.x & 31;
  const int w00 = 32 * ci0, wc0 = min(w00 + lane, ln.live - 1);
  Window cur = chunk_window(tw, w00, wc0, tr.lref, tr.lo, tr.hi, ln.P);
  if (cur.len <= cap)
    stage_window(xb, plane, cur, w00, wc0, aligned && w00 + 32 <= ln.stride, nc, cap, ln,
                 xs + (ci0 & 1) * buf);
  __pipeline_commit();
  for (int ci = ci0; ci < ci1; ++ci) {
    const int w = 32 * ci + lane, wc = min(w, ln.live - 1);
    __pipeline_wait_prior(0);              // this thread's copies of this chunk
    __syncthreads();                       // everyone's; and the last chunk summed: its buffer is free
    Window nxt{0, 0, 0};
    if (ci + 1 < ci1) {                    // the next chunk's copies fly while this one sums
      const int w0n = 32 * (ci + 1), wn = min(w + 32, ln.live - 1);
      nxt = chunk_window(tw, w0n, wn, tr.lref, tr.lo, tr.hi, ln.P);
      if (nxt.len <= cap)
        stage_window(xb, plane, nxt, w0n, wn, aligned && w0n + 32 <= ln.stride, nc, cap, ln,
                     xs + ((ci + 1) & 1) * buf);
      __pipeline_commit();
    }
    if (tr.has_row) {
      if (cur.len <= cap)
        pass1_row<true>(xb, plane, xs + (ci & 1) * buf, cap, tr.il, tr.vl, tr.n, tr.u_lane,
                        tr.m_lane, ln, w, wc, tw[wc], fw[wc], cur.base, tr.lref, nc, y1r, y1_cs);
      else
        pass1_row<false>(xb, plane, xs, cap, tr.il, tr.vl, tr.n, tr.l_lane, tr.m_lane, ln, w,
                         wc, tw[wc], fw[wc], 0, tr.lref, nc, y1r, y1_cs);
    }
    cur = nxt;
  }
}

// ---------------------------------------------------------------- host

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace ada_warp
