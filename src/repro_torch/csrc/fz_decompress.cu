// K6 fused_decompress for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_decode.py:fused_decompress:
// packed flags + payload (+ outlier residuals) -> f32[shape], bit-identical to
// dual_dequantize(bitunshuffle(decode(...))).
//
// Design. The TPU kernel walks the stream in order and carries the payload
// read offset and the inverse-Lorenzo running sums across grid steps. CTAs on
// the card run in no order, so this first version is a short sequence of
// launches inside one call, all on the caller's stream:
//   1. decode_tiles: one CTA per tile; payload read offset from a decoupled
//      look-back scan over the tiles' flag counts; gather (zero if unflagged
//      or past capacity), unshuffle by warp ballot, code -> int32 delta;
//   2. add_residuals: the outlier residuals at idx < n (integer atomics);
//   3. scan_columns: the inclusive prefix along each non-last axis, one thread
//      per column, neighbouring threads on neighbouring columns;
//   4. scan_rows_dequant: the inclusive prefix along the last axis (a 1D
//      array is one row) with a look-back across 4096-element segments, then
//      float(q) * (2 eb).
// All adds are integer modulo 2**32, so any order gives the reference's bits.
// Bound: bytes (flags + used payload + outliers read once, f32 output written
// once). The int32 buffer between the launches costs 4n bytes written by (1),
// 8n per column pass and 4n read by (4): the cost of not fusing yet.
#include "fz_common.cuh"

namespace fz {

constexpr int SEG = 4096;                 // elements per row-scan segment
constexpr int PER_THREAD = SEG / THREADS; // 16

__device__ __forceinline__ int from_code(unsigned c, int zigzag) {
  if (!zigzag) {
    const int mag = static_cast<int>(c & 0x7FFFu);
    return (c & 0x8000u) ? -mag : mag;
  }
  return static_cast<int>((c >> 1) ^ (0u - (c & 1u)));
}

__global__ void __launch_bounds__(THREADS)
decode_tiles(const uint32_t* __restrict__ bitflags, const uint16_t* __restrict__ payload,
             long long capacity, int zigzag, int n, int* __restrict__ delta,
             unsigned long long* st, unsigned* ticket) {
  __shared__ __align__(16) uint16_t sh[TILE];        // shuffled tile, plane-major
  __shared__ uint32_t fw[FLAG_WORDS_PER_TILE];
  const int t = static_cast<int>(take_ticket(ticket));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < FLAG_WORDS_PER_TILE)
    fw[threadIdx.x] = bitflags[static_cast<long long>(t) * FLAG_WORDS_PER_TILE + threadIdx.x];
  __syncthreads();

  unsigned agg = 0;
  if (warp == 0) agg = warp_sum(lane < FLAG_WORDS_PER_TILE ? __popc(fw[lane]) : 0u);
  const unsigned base = scan_segment(st, t, 0, agg);

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

  // unshuffle: lane l holds word (plane l & 15) of group 2c + (l >> 4)
  for (int c = warp; c < TILE / 32; c += WARPS) {
    const unsigned code =
        unshuffle_warp(sh[(lane & 15) * GROUPS_PER_TILE + 2 * c + (lane >> 4)]);
    const int p = t * TILE + c * 32 + lane;
    if (p < n) delta[p] = from_code(code, zigzag);
  }
}

__global__ void add_residuals(const int* __restrict__ idx, const int* __restrict__ val,
                              int count, int n, int* delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) {
    const int j = idx[i];
    if (j >= 0 && j < n) atomicAdd(reinterpret_cast<unsigned*>(delta) + j,
                                   static_cast<unsigned>(val[i]));
  }
}

// Inclusive prefix along an axis of length `len` for every (outer, inner) column.
__global__ void scan_columns(int* q, int outer, int len, int inner) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (id >= static_cast<long long>(outer) * inner) return;
  const long long o = id / inner, in = id - o * inner;
  unsigned* col = reinterpret_cast<unsigned*>(q) + o * len * inner + in;
  unsigned acc = 0;
  for (int i = 0; i < len; ++i) {
    acc += col[static_cast<long long>(i) * inner];
    col[static_cast<long long>(i) * inner] = acc;
  }
}

// Inclusive prefix along rows of `row_len` elements, segments of SEG chained by
// a look-back inside each row, then dequantization.
__global__ void __launch_bounds__(THREADS)
scan_rows_dequant(const int* __restrict__ q, float* __restrict__ out, int row_len,
                  int segs_per_row, const float* __restrict__ eb,
                  unsigned long long* st, unsigned* ticket) {
  __shared__ unsigned buf[SEG + SEG / 32];           // padded: no bank conflicts
  __shared__ unsigned warp_tot[WARPS];
  const long long seg = take_ticket(ticket);
  const long long row = seg / segs_per_row;
  const int k = static_cast<int>(seg - row * segs_per_row);
  const long long start = row * row_len + static_cast<long long>(k) * SEG;
  const int cnt = min(SEG, row_len - k * SEG);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned* src = reinterpret_cast<const unsigned*>(q) + start;

  for (int i = threadIdx.x; i < SEG; i += THREADS)
    buf[i + (i >> 5)] = i < cnt ? src[i] : 0u;
  __syncthreads();

  // each thread scans its 16 consecutive elements, then the block scans the totals
  unsigned v[PER_THREAD], run = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x * PER_THREAD + j;
    run += buf[i + (i >> 5)];
    v[j] = run;
  }
  unsigned incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  unsigned before = 0, agg = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before += warp_tot[w];
    agg += warp_tot[w];
  }
  const unsigned thread_excl = before + incl - run;
  const unsigned base = scan_segment(st, seg, row * segs_per_row, agg);

  const float two_eb = 2.0f * *eb;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = threadIdx.x * PER_THREAD + j;
    buf[i + (i >> 5)] = base + thread_excl + v[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cnt; i += THREADS)
    out[start + i] = __fmul_rn(__int2float_rn(static_cast<int>(buf[i + (i >> 5)])), two_eb);
}

}  // namespace fz

extern "C" {

const char* fz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Look-back words and tickets the caller must zero, as one int64 buffer:
// n_tiles + rows * segs_per_row words, then one word holding two tickets.
long long fz_decompress_scratch_words(long long n_tiles, long long rows, long long row_len) {
  return n_tiles + rows * ((row_len + fz::SEG - 1) / fz::SEG) + 1;
}

// K6. dims (d0, d1, d2) of `ndim` dims, n = d0 * d1 * d2 < 2**31 - 4096.
// oidx/oval: n_out outlier residuals (may be 0). qbuf: int32[n] scratch.
// Returns a cudaError_t.
int fz_fused_decompress(const uint32_t* bitflags, const uint16_t* payload,
                        long long capacity, const float* eb, int zigzag, int ndim,
                        long long d0, long long d1, long long d2, const int* oidx,
                        const int* oval, long long n_out, int* qbuf, float* out,
                        unsigned long long* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(d0 * d1 * d2);
  const int n_tiles = (n + fz::TILE - 1) / fz::TILE;
  const long long dims[3] = {d0, d1, d2};
  const int row_len = static_cast<int>(dims[ndim - 1]);
  const int rows = n / row_len;
  const int segs_per_row = (row_len + fz::SEG - 1) / fz::SEG;
  unsigned long long* st_rows = scratch + n_tiles;
  unsigned* tickets =
      reinterpret_cast<unsigned*>(scratch + n_tiles + static_cast<long long>(rows) * segs_per_row);
  cudaError_t e;

  fz::decode_tiles<<<n_tiles, fz::THREADS, 0, s>>>(bitflags, payload, capacity, zigzag, n,
                                                   qbuf, scratch, tickets);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (n_out > 0) {
    fz::add_residuals<<<static_cast<int>((n_out + 255) / 256), 256, 0, s>>>(
        oidx, oval, static_cast<int>(n_out), n, qbuf);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  // every non-last axis a: outer = prod(dims[:a]), inner = prod(dims[a+1:])
  long long outer = 1;
  for (int a = 0; a + 1 < ndim; ++a) {
    long long inner = 1;
    for (int b = a + 1; b < ndim; ++b) inner *= dims[b];
    const long long cols = outer * inner;
    fz::scan_columns<<<static_cast<int>((cols + 255) / 256), 256, 0, s>>>(
        qbuf, static_cast<int>(outer), static_cast<int>(dims[a]), static_cast<int>(inner));
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    outer *= dims[a];
  }
  fz::scan_rows_dequant<<<rows * segs_per_row, fz::THREADS, 0, s>>>(
      qbuf, out, row_len, segs_per_row, eb, st_rows, tickets + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
