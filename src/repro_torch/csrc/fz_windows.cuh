// Lorenzo codes from pre-quantized windows in shared memory, for Hopper
// (sm_90a): the code source of K4 fused_compress (fz_compress.cu) and of K1
// lorenzo_quant's tile step (fz_staged.cu).
//
// The neighbours of codes [p0, p0 + 4096) at offset o in {0, row, plane,
// plane + row} (as many as the dims have) lie in the window [p0 - o - 1,
// p0 - o + 4096). The host merges the windows that overlap or touch
// (plan_windows; the layout is the same for every tile), a CTA pre-quantizes
// every element of them once into shared memory with 16-byte loads over a
// chunk-aligned superset, and thread g makes the Lorenzo deltas of codes
// 16 g .. 16 g + 15 from there (WindowCodes). The buffer is padded by one word
// every 16 (word w at w + w / 16), so that a warp's group reads (a stride of
// 16 words) fall in 32 distinct banks and a thread's 4 or 8 quantized words
// stay contiguous.
//
// Exactness: fz_common.cuh's quantize (a true IEEE divide, round half to
// even, converted as XLA does); the deltas wrap in unsigned 32-bit
// arithmetic; bf16 widens by its raw bits. Build without --use_fast_math.
#pragma once

#include <climits>

#include "fz_common.cuh"

namespace fz {

constexpr int MAX_WINDOWS = 4;     // Lorenzo neighbour offsets in 3-D
constexpr int LOAD_BATCH = 3;      // 16-byte loads in flight a thread

// Word w of the window buffer, one pad word every 16: a warp's group reads
// (16 g + c for lanes g) land at 17 g + padded(c), 32 distinct banks.
__device__ __forceinline__ int padded(int w) { return w + (w >> 4); }

// Where a tile's Lorenzo neighbours lie in the window buffer; the same for
// every tile. The buffer holds the merged windows' chunks one after another:
// chunk f (words f * VEC ..) of segment s holds elements p0 + off[s] + f * VEC.
struct Windows {
  int chunks;                  // chunks of VEC elements, all segments
  int end[MAX_WINDOWS];        // chunks through segment s (INT_MAX past the last)
  int off[MAX_WINDOWS];        // element of chunk f of segment s, less p0 + f * VEC
  int shift[MAX_WINDOWS];      // element p0 + r - o_k is at word shift[k] + r
  // byte offset of element p0 + 16 g + e - o_k (e = -1 .. 15) from group g's
  // view of the buffer (buf + 17 g): 4 * padded(shift[k] + e), so that a
  // group read costs one add to a constant and the load
  int col[MAX_WINDOWS][17];
};

// The general Lorenzo term of one neighbour offset for group g, gated per
// code: adds (sub: subtracts) q(p - o) - q(p - o - 1) where `gate` has the
// code's bit, without the second where `km` lacks it (a row start). row_g:
// the buffer seen from group g (buf + 17 g); shift: shift[k].
__device__ __forceinline__ void lorenzo_term(const unsigned* row_g, int shift, unsigned gate,
                                             unsigned km, bool sub, unsigned d[16]) {
  unsigned prev = row_g[padded(shift - 1)];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const unsigned cur = row_g[padded(shift + e)];
    const unsigned t = cur - (((km >> e) & 1u) ? prev : 0u);
    if ((gate >> e) & 1u) d[e] = sub ? d[e] - t : d[e] + t;
    prev = cur;
  }
}

// The codes of K4 and of K1's tile step: float data of ND dims (BF16: raw
// bits); row = last axis, plane = last two axes, rows = rows in a plane.
template <bool BF16, int ND>
struct WindowCodes {
  static constexpr int VEC = BF16 ? 8 : 4;     // elements a 16-byte chunk
  static constexpr int SEGS = ND == 3 ? MAX_WINDOWS : ND;
  // at most 48 registers a thread: 5 CTAs an SM, as the windows' shared
  // memory allows at (100, 500, 500) (39 KB a CTA)
  static constexpr int MIN_CTAS = 5;
  static constexpr bool STRICT = false;        // no outlier channel (WindowCodesStrict)
  const void* x;
  const float* eb;                 // device scalar: the absolute error bound
  int n, row, plane, rows;
  int zigzag;
  Windows win;

  // Term K for a group whose gate is one value throughout: q(p - o) -
  // q(p - o - 1) for every code (the row start is mended afterwards).
  template <int K>
  __device__ __forceinline__ void lorenzo_term_fast(const unsigned* row_g, bool on, bool sub,
                                                    unsigned d[16]) const {
    if (!on) return;
    const char* b = reinterpret_cast<const char*>(row_g);
    unsigned prev = *reinterpret_cast<const unsigned*>(b + win.col[K][0]);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const unsigned cur = *reinterpret_cast<const unsigned*>(b + win.col[K][e + 1]);
      d[e] = sub ? d[e] - cur + prev : d[e] + cur - prev;
      prev = cur;
    }
  }

  __device__ __forceinline__ float at(int e) const {
    return BF16 ? widen_bf16(static_cast<const uint16_t*>(x)[e])
                : static_cast<const float*>(x)[e];
  }

  // Pre-quantizes every element of the tile's windows inside [0, n) into
  // buf; LOAD_BATCH chunks a thread in flight. The window fields are read
  // with constant indices only (a parameter array indexed at run time is
  // copied to local memory).
  __device__ void load(unsigned* buf, int p0) const {
    const float two_eb = 2.0f * *eb;
    for (int f0 = threadIdx.x; f0 < win.chunks; f0 += LOAD_BATCH * THREADS) {
      uint4 v[LOAD_BATCH];
      int e0[LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int f = f0 + u * THREADS;
        int off = win.off[0];
#pragma unroll
        for (int s = 1; s < SEGS; ++s)
          if (f >= win.end[s - 1]) off = win.off[s];
        e0[u] = p0 + off + f * VEC;
        if (f < win.chunks && e0[u] >= 0 && e0[u] + VEC <= n)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              static_cast<const char*>(x) + static_cast<long long>(e0[u]) * (BF16 ? 2 : 4)));
      }
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int f = f0 + u * THREADS;
        if (f >= win.chunks) break;
        unsigned* dst = buf + padded(f * VEC);       // a chunk never crosses a pad word
        if (e0[u] >= 0 && e0[u] + VEC <= n) {
          const unsigned raw[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float val = BF16 ? widen_bf16((raw[j >> 1] >> (16 * (j & 1))) & 0xFFFFu)
                                   : __uint_as_float(raw[j]);
            dst[j] = quantize(val, two_eb);
          }
        } else {                                     // a chunk across 0 or n
          for (int j = 0; j < VEC; ++j)
            if (e0[u] + j >= 0 && e0[u] + j < n) dst[j] = quantize(at(e0[u] + j), two_eb);
        }
      }
    }
  }

  // Group g's 16 codes (0 past n); RAW: the int32 Lorenzo deltas instead, as
  // unsigned (0 past n). Called by all threads.
  template <bool RAW = false>
  __device__ __forceinline__ void codes(unsigned* buf, int p0, int g, unsigned code[16]) const {
    load(buf, p0);
    const int p = p0 + g * 16;
    int i = 0, j = 0, k = p;                    // plane, row in the plane, column
    if (ND == 2) {
      j = p / row;
      k = p - j * row;
    } else if (ND == 3) {
      i = p / plane;
      const int r = p - i * plane;
      j = r / row;
      k = r - j * row;
    }
    // the first row start at or after p is code e1 (16: none in the group);
    // (ia, ja): plane and row from there on
    const int e1 = ND == 1 ? (p == 0 ? 0 : 16) : (k == 0 ? 0 : min(row - k, 16));
    int ia = i, ja = j;
    if (ND >= 2 && k > 0 && ++ja == rows && ND == 3) {
      ja = 0;
      ++ia;
    }
    const bool on1 = j > 0, on2 = i > 0;
    // one gate value per term throughout the group (rows of 16 or more hold
    // at most one row start): the gate-free path
    const bool fast = ND == 1 || (row >= 16 && (e1 == 16 || ((ja > 0) == on1 && (ia > 0) == on2)));
    unsigned km = 0xFFFFu, jm = 0, im = 0;      // the general path's per-code gates
    if (!fast) {
      for (int e = 0; e < 16; ++e) {
        km ^= static_cast<unsigned>(k == 0) << e;
        jm |= static_cast<unsigned>(j > 0) << e;
        im |= static_cast<unsigned>(i > 0) << e;
        if (++k == row) {
          k = 0;
          if (++j == rows && ND == 3) {
            j = 0;
            ++i;
          }
        }
      }
    }
    __syncthreads();                                 // the windows are complete
    const unsigned* row_g = buf + 17 * g;
    unsigned d[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) d[e] = 0u;
    if (fast) {
      lorenzo_term_fast<0>(row_g, true, false, d);
      if (ND >= 2) lorenzo_term_fast<1>(row_g, on1, true, d);
      if (ND == 3) {
        lorenzo_term_fast<2>(row_g, on2, true, d);
        lorenzo_term_fast<3>(row_g, on1 && on2, false, d);
      }
      // at a row start (code e1) no column neighbour is subtracted: add back
      // what each term took (for p = 0 that is a word never written, taken
      // and given back alike)
      const int c = min(e1, 15) - 1;
      unsigned fix = row_g[padded(win.shift[0] + c)];
      if (ND >= 2 && on1) fix -= row_g[padded(win.shift[1] + c)];
      if (ND == 3 && on2) fix -= row_g[padded(win.shift[2] + c)];
      if (ND == 3 && on1 && on2) fix += row_g[padded(win.shift[3] + c)];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (e == e1) d[e] += fix;
    } else {
      lorenzo_term(row_g, win.shift[0], 0xFFFFu, km, false, d);
      if (ND >= 2) lorenzo_term(row_g, win.shift[1], jm, km, true, d);
      if (ND == 3) {
        lorenzo_term(row_g, win.shift[2], im, km, true, d);
        lorenzo_term(row_g, win.shift[3], im & jm, km, false, d);
      }
    }
    const int valid = n - p;
    if constexpr (RAW) {
#pragma unroll
      for (int e = 0; e < 16; ++e) code[e] = e < valid ? d[e] : 0u;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        code[e] = e < valid ? to_code(static_cast<int>(d[e]), zigzag) : 0u;
    }
  }
};

// Strict K4's source: the same codes, and the exact outlier channel (the
// first `ocap` overflows in flat order: flat index in idx, residual in val)
// with the uncapped overflow count in *n_over. ost: the overflow counts'
// look-back words, zeroed by the caller.
template <bool BF16, int ND>
struct WindowCodesStrict : WindowCodes<BF16, ND> {
  static constexpr bool STRICT = true;
  int* idx;
  int* val;
  long long ocap;
  int* n_over;
  unsigned long long* ost;
};

// The windows of offsets {0, row, plane, plane + row} (the first `count`),
// merged where they overlap or touch, each widened to whole 16-byte chunks of
// `vec` elements for data whose element 0 is `mis` elements past a 16-byte
// boundary.
inline Windows plan_windows(int count, int row, int plane, int vec, int mis) {
  const int offs[MAX_WINDOWS] = {0, row, plane, plane + row};
  int order[MAX_WINDOWS];                  // by window start: the largest offset first
  for (int k = 0; k < count; ++k) order[k] = k;
  for (int a = 1; a < count; ++a)
    for (int b = a; b > 0 && offs[order[b]] > offs[order[b - 1]]; --b) {
      const int tmp = order[b];
      order[b] = order[b - 1];
      order[b - 1] = tmp;
    }
  int nseg = 0, seg_of[MAX_WINDOWS], lo[MAX_WINDOWS], hi[MAX_WINDOWS];
  for (int a = 0; a < count; ++a) {
    const int k = order[a], s = -offs[k] - 1, e = -offs[k] + TILE;
    if (nseg > 0 && s <= hi[nseg - 1]) {
      hi[nseg - 1] = max(hi[nseg - 1], e);
    } else {
      lo[nseg] = s;
      hi[nseg] = e;
      ++nseg;
    }
    seg_of[k] = nseg - 1;
  }
  Windows w{};
  for (int s = 0; s < MAX_WINDOWS; ++s) {
    w.end[s] = INT_MAX;
    if (s >= nseg) continue;
    const int sa = lo[s] - (((lo[s] + mis) % vec) + vec) % vec;
    const int ea = hi[s] + (((-(hi[s] + mis)) % vec) + vec) % vec;
    w.off[s] = sa - w.chunks * vec;             // the segment starts at word chunks * vec
    w.chunks += (ea - sa) / vec;
    w.end[s] = w.chunks;
  }
  for (int k = 0; k < count; ++k) {
    w.shift[k] = -w.off[seg_of[k]] - offs[k];
    for (int e = -1; e < 16; ++e) {
      const int word = w.shift[k] + e;
      w.col[k][e + 1] = static_cast<int>(sizeof(unsigned)) * (word + (word >> 4));
    }
  }
  return w;
}

// Dynamic shared bytes of a CTA holding the windows `w` of `vec`-element
// chunks: one pad word every 16, plus one.
inline size_t window_smem(const Windows& w, int vec) {
  const size_t words = static_cast<size_t>(w.chunks) * vec;
  return sizeof(unsigned) * (words + words / 16 + 1);
}

}  // namespace fz
