// K6 fused_decompress for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_decode.py:fused_decompress:
// packed flags + payload (+ outlier residuals) -> f32[shape], bit-identical to
// dual_dequantize(bitunshuffle(decode(...))).
//
// Bound: bytes. The function reads the flags, the used payload and the
// outlier slots once and writes 4n bytes of float32.
//
// Design. The TPU kernel walks the stream in order and carries the payload
// read offset and the inverse-Lorenzo running sums across grid steps. CTAs on
// the card run in no order, so both carries become decoupled look-backs over
// tiles taken in ticket order. The wrapper drops axes of size 1 (a prefix
// along them is the identity). One call, on the caller's stream:
//   1. bin_residuals (only with outlier slots): each slot whose index is in
//      [0, n) takes a place in its tile's bin (BIN_CAP places; an overflowing
//      tile scans every slot instead). Slots may come in any order and repeat.
//   2. decode_scan_rows: one CTA per 4096-element tile: payload offset by
//      look-back over the tiles' flag counts; gather (zero if unflagged or
//      past capacity); unshuffle in registers, one 16-code group a thread
//      (a 16x16 bit transpose, about 12 operations a code); code -> int32
//      delta; the tile's
//      residuals added through shared memory; then the inclusive prefix
//      along the last axis as a segmented scan in flat order, resetting at
//      every row start, chained across tiles by a segmented look-back (a tile
//      holding a row start publishes at once). A 1-D array is one row: this
//      launch dequantizes, float(q) * (2 eb), and writes float32 directly.
//      Otherwise it writes the int32 q into the output's own memory.
//   3. scan_columns, once per remaining axis (2-D: axis 0; 3-D: axis 1, then
//      axis 0), in place: a CTA a strip of 32 neighbouring columns, its 8
//      warps splitting the column length (a carry between them through
//      shared memory, the strip kept there); the last pass dequantizes and
//      writes float32 over the int32 it read.
// All adds are integer modulo 2**32, so any order gives the reference's bits.
//
// Bytes per shape (n elements; plus the compressed input and the look-back
// words, 16 bytes a tile): 1-D 4n (the bound); 2-D 12n (4n from 2, 8n from
// one column pass); 3-D 20n (two column passes). A column pass keeps its rows
// in shared memory between its two passes when they fit (len <= 768). The column passes are what
// is left above the bound: a column prefix cannot start before the rows
// above it are done, and fusing both axes of a 3-D plane into one pass would
// leave too few independent columns to fill the card.
#include "fz_common.cuh"

namespace fz {

constexpr int PER_THREAD = TILE / THREADS;   // 16 consecutive elements a thread
constexpr int BIN_CAP = 32;                  // residual places a tile
constexpr int COL_BATCH = 16;                // loads in flight a column thread

__device__ __forceinline__ int from_code(unsigned c, int zigzag) {
  if (!zigzag) {
    const int mag = static_cast<int>(c & 0x7FFFu);
    return (c & 0x8000u) ? -mag : mag;
  }
  return static_cast<int>((c >> 1) ^ (0u - (c & 1u)));
}

__device__ __forceinline__ float dequant(unsigned q, float two_eb) {
  return __fmul_rn(__int2float_rn(static_cast<int>(q)), two_eb);
}

// Segmented-scan pair: (holds a row start, sum since the last start).
struct Seg {
  unsigned f, v;
};
// a then b (a earlier in flat order)
__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {
  return {a.f | b.f, b.f ? b.v : a.v + b.v};
}

__global__ void bin_residuals(const int* __restrict__ idx, long long count, int n,
                              unsigned* __restrict__ bin_count, int* __restrict__ bins) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int j = idx[i];
  if (j < 0 || j >= n) return;
  const int t = j / TILE;
  const unsigned r = atomicAdd(bin_count + t, 1u);
  if (r < BIN_CAP) bins[static_cast<long long>(t) * BIN_CAP + r] = static_cast<int>(i);
}

// At most 64 registers a thread: 4 CTAs an SM, so a serving page's 512 tiles
// are resident at once.
__global__ void __launch_bounds__(THREADS, 4)
decode_scan_rows(const uint32_t* __restrict__ bitflags, const uint16_t* __restrict__ payload,
                 long long capacity, int zigzag, int n, int row_len,
                 const int* __restrict__ oidx, const int* __restrict__ oval, long long n_out,
                 const unsigned* __restrict__ bin_count, const int* __restrict__ bins,
                 const float* __restrict__ eb, int write_f32, void* __restrict__ out,
                 unsigned long long* st_flags, unsigned long long* st_rows, unsigned* ticket) {
  __shared__ __align__(16) uint16_t sh[TILE];        // shuffled tile, plane-major
  __shared__ unsigned buf[TILE + TILE / 32];         // deltas, then q; padded
  __shared__ uint32_t fw[FLAG_WORDS_PER_TILE];
  __shared__ Seg warp_agg[WARPS];
  const int t = static_cast<int>(take_ticket(ticket));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = t * TILE;
  if (threadIdx.x < FLAG_WORDS_PER_TILE)
    fw[threadIdx.x] = bitflags[static_cast<long long>(t) * FLAG_WORDS_PER_TILE + threadIdx.x];
  __syncthreads();

  // payload offset: exclusive prefix of the flag counts
  unsigned agg = 0;
  if (warp == 0) agg = warp_sum(lane < FLAG_WORDS_PER_TILE ? __popc(fw[lane]) : 0u);
  const unsigned base = scan_segment(st_flags, t, 0, agg);

  const uint4* rows = reinterpret_cast<const uint4*>(payload);
  uint4* blocks = reinterpret_cast<uint4*>(sh);
  for (int b = threadIdx.x; b < BLOCKS_PER_TILE; b += THREADS) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if ((fw[b >> 5] >> (b & 31)) & 1u) {
      const long long off = static_cast<long long>(base) + flags_before(fw, b);
      if (off < capacity) v = rows[off];
    }
    blocks[b] = v;
  }
  __syncthreads();

  // unshuffle in registers: thread g holds group g, the tile's elements
  // 16 g .. 16 g + 15, as int32 deltas
  const int i0 = threadIdx.x * PER_THREAD;
  unsigned v[PER_THREAD];
  unshuffle_group(sh, threadIdx.x, v);
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    v[j] = p0 + i0 + j < n ? static_cast<unsigned>(from_code(v[j], zigzag)) : 0u;

  // this tile's outlier residuals, added to the deltas before any prefix
  if (n_out > 0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) buf[i0 + j + ((i0 + j) >> 5)] = v[j];
    __syncthreads();
    const unsigned cnt = bin_count[t];
    const int hi = min(TILE, n - p0);
    if (cnt <= static_cast<unsigned>(BIN_CAP)) {
      for (int r = threadIdx.x; r < static_cast<int>(cnt); r += THREADS) {
        const int s = bins[static_cast<long long>(t) * BIN_CAP + r];
        const int i = oidx[s] - p0;
        atomicAdd(buf + i + (i >> 5), static_cast<unsigned>(oval[s]));
      }
    } else {                                 // an overflowing bin: scan every slot
      for (long long s = threadIdx.x; s < n_out; s += THREADS) {
        const int i = oidx[s] - p0;
        if (i >= 0 && i < hi) atomicAdd(buf + i + (i >> 5), static_cast<unsigned>(oval[s]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) v[j] = buf[i0 + j + ((i0 + j) >> 5)];
  }

  // segmented inclusive scan: each thread its 16 consecutive elements ...
  int rem = (p0 + i0) % row_len;
  unsigned run = 0;
  int first_start = PER_THREAD;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (rem == 0) {
      run = 0;
      first_start = min(first_start, j);
    }
    run += v[j];
    v[j] = run;
    rem = rem + 1 == row_len ? 0 : rem + 1;
  }
  // ... then the warp ...
  const Seg mine = {first_start < PER_THREAD ? 1u : 0u, run};
  Seg incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg y = {__shfl_up_sync(0xffffffffu, incl.f, o), __shfl_up_sync(0xffffffffu, incl.v, o)};
    if (lane >= o) incl = seg_combine(y, incl);
  }
  Seg excl = {__shfl_up_sync(0xffffffffu, incl.f, 1), __shfl_up_sync(0xffffffffu, incl.v, 1)};
  if (lane == 0) excl = {0u, 0u};
  if (lane == 31) warp_agg[warp] = incl;
  __syncthreads();
  // ... then the tile, then the tiles before it
  Seg before = {0u, 0u}, tile_agg = {0u, 0u};
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before = seg_combine(before, warp_agg[w]);
    tile_agg = seg_combine(tile_agg, warp_agg[w]);
  }
  excl = seg_combine(before, excl);
  const unsigned carry =
      scan_segment_rows(st_rows, t, tile_agg.v, tile_agg.f != 0, p0 % row_len != 0);
  const unsigned x = excl.f ? excl.v : carry + excl.v;   // running sum before my elements
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = i0 + j;
    buf[i + (i >> 5)] = j < first_start ? x + v[j] : v[j];
  }
  __syncthreads();

  // coalesced 16-byte stores: thread k writes elements 4k..4k+3 of each 1024
  const int cnt = min(TILE, n - p0);
  const float two_eb = 2.0f * *eb;
  for (int i = threadIdx.x * 4; i < cnt; i += THREADS * 4) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = buf[i + k + ((i + k) >> 5)];
    if (write_f32) {
      float* o = static_cast<float*>(out) + p0 + i;
      if (i + 4 <= cnt) {
        *reinterpret_cast<float4*>(o) =
            make_float4(dequant(w[0], two_eb), dequant(w[1], two_eb), dequant(w[2], two_eb),
                        dequant(w[3], two_eb));
      } else {
        for (int k = 0; k < cnt - i; ++k) o[k] = dequant(w[k], two_eb);
      }
    } else {
      unsigned* o = static_cast<unsigned*>(out) + p0 + i;
      if (i + 4 <= cnt) {
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int k = 0; k < cnt - i; ++k) o[k] = w[k];
      }
    }
  }
}

// Inclusive prefix, in place, along an axis of length `len` for every
// (outer, inner) column. A CTA takes 32 neighbouring columns of one outer
// index (a warp reads 128 contiguous bytes a row) and splits `len` among its
// 8 warps: each warp sums its rows (COL_BATCH loads in flight a thread), the
// warps' sums give each its carry through shared memory, and each warp then
// writes the prefix of its rows. The rows read in the first pass are kept in
// shared memory when the strip fits (len x 128 bytes <= STASH_BYTES), else
// read again (from L2 if still there). The serial chain of a thread is about
// len / (8 * COL_BATCH) batches of loads. DEQ: the last pass, which writes
// float32 over the int32 it reads.
constexpr int STASH_BYTES = 96 * 1024;
template <bool DEQ>
__global__ void __launch_bounds__(THREADS)
scan_columns(unsigned* q, int len, long long inner, long long strips, int stash,
             const float* __restrict__ eb) {
  extern __shared__ unsigned rowbuf[];       // len x 32, when stash
  __shared__ unsigned part[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long o = blockIdx.x / strips;
  const long long in = (blockIdx.x - o * strips) * 32 + lane;
  const bool live = in < inner;
  unsigned* col = q + o * len * inner + in;
  const int rows = (len + WARPS - 1) / WARPS;
  const int r0 = min(len, warp * rows), r1 = min(len, r0 + rows);
  unsigned sum = 0;
  for (int i0 = r0; i0 < r1; i0 += COL_BATCH) {
    unsigned x[COL_BATCH];
#pragma unroll
    for (int u = 0; u < COL_BATCH; ++u)
      x[u] = live && i0 + u < r1 ? col[(i0 + u) * inner] : 0u;
#pragma unroll
    for (int u = 0; u < COL_BATCH; ++u) {
      sum += x[u];
      if (stash && i0 + u < r1) rowbuf[(i0 + u) * 32 + lane] = x[u];
    }
  }
  part[warp][lane] = sum;
  __syncthreads();
  unsigned acc = 0;
  for (int w = 0; w < warp; ++w) acc += part[w][lane];
  if (!live) return;
  const float two_eb = DEQ ? 2.0f * *eb : 0.0f;
  for (int i0 = r0; i0 < r1; i0 += COL_BATCH) {
    unsigned x[COL_BATCH];
#pragma unroll
    for (int u = 0; u < COL_BATCH; ++u)     // every load of the batch before any store
      if (i0 + u < r1) x[u] = stash ? rowbuf[(i0 + u) * 32 + lane] : col[(i0 + u) * inner];
#pragma unroll
    for (int u = 0; u < COL_BATCH; ++u) {
      if (i0 + u < r1) {
        acc += x[u];
        if (DEQ)
          reinterpret_cast<float*>(col)[(i0 + u) * inner] = dequant(acc, two_eb);
        else
          col[(i0 + u) * inner] = acc;
      }
    }
  }
}

// Dynamic shared bytes of a column pass over columns of `len`: the strip's
// rows where they fit in STASH_BYTES, else none (the rows are read again).
inline size_t columns_smem(int len) {
  const size_t smem = static_cast<size_t>(len) * 32 * sizeof(unsigned);
  return smem <= static_cast<size_t>(STASH_BYTES) ? smem : 0;
}

template <bool DEQ>
int launch_columns(unsigned* q, int len, long long inner, long long outer, const float* eb,
                   cudaStream_t s) {
  const long long strips = (inner + 31) / 32;
  const size_t smem = columns_smem(len);
  const int stash = smem > 0;
  if (stash && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_columns<DEQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, STASH_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  scan_columns<DEQ><<<static_cast<unsigned>(outer * strips), THREADS, smem, s>>>(
      q, len, inner, strips, stash, eb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fz

extern "C" {

const char* fz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Int64 words the caller must zero: two look-back words a tile and one word
// of tickets; with outlier slots, the residual bins (a count and BIN_CAP
// places a tile, int32).
long long fz_decompress_scratch_words(long long n_tiles, int with_outliers) {
  return 2 * n_tiles + 1 + (with_outliers ? (n_tiles * (1 + fz::BIN_CAP) + 1) / 2 : 0);
}

// Dynamic shared bytes that a column pass of fz_fused_decompress over columns
// of `len` sets.
long long fz_scan_columns_smem(int len) {
  return static_cast<long long>(fz::columns_smem(len));
}

// K6. dims (d0, d1, d2) of `ndim` dims, none of size 1 unless n == 1,
// n = d0 * d1 * d2 < 2**31 - 4096. oidx/oval: n_out outlier residuals (may be
// 0). out: f32[n], also the int32 scratch of the column passes. Returns a
// cudaError_t.
int fz_fused_decompress(const uint32_t* bitflags, const uint16_t* payload,
                        long long capacity, const float* eb, int zigzag, int ndim,
                        long long d0, long long d1, long long d2, const int* oidx,
                        const int* oval, long long n_out, float* out,
                        unsigned long long* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(d0 * d1 * d2);
  const long long n_tiles = (n + fz::TILE - 1) / fz::TILE;
  const long long dims[3] = {d0, d1, d2};
  unsigned long long* st_flags = scratch;
  unsigned long long* st_rows = scratch + n_tiles;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + 2 * n_tiles);
  unsigned* bin_count = reinterpret_cast<unsigned*>(scratch + 2 * n_tiles + 1);
  int* bins = reinterpret_cast<int*>(bin_count + n_tiles);
  cudaError_t e;

  if (n_out > 0) {
    fz::bin_residuals<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, s>>>(
        oidx, n_out, n, bin_count, bins);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  fz::decode_scan_rows<<<static_cast<unsigned>(n_tiles), fz::THREADS, 0, s>>>(
      bitflags, payload, capacity, zigzag, n, static_cast<int>(dims[ndim - 1]), oidx, oval,
      n_out, bin_count, bins, eb, ndim == 1, out, st_flags, st_rows, ticket);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  // every other axis a, the last pass on axis 0: outer = prod(dims[:a]),
  // inner = prod(dims[a+1:])
  for (int a = ndim - 2; a >= 0; --a) {
    long long outer = 1, inner = 1;
    for (int b = 0; b < a; ++b) outer *= dims[b];
    for (int b = a + 1; b < ndim; ++b) inner *= dims[b];
    unsigned* q = reinterpret_cast<unsigned*>(out);
    const int len = static_cast<int>(dims[a]);
    const int rc = a == 0 ? fz::launch_columns<true>(q, len, inner, outer, eb, s)
                          : fz::launch_columns<false>(q, len, inner, outer, eb, s);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
