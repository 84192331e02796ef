// The staged route's kernels for Hopper (sm_90a): K1 lorenzo_quant, K2
// bitshuffle_flag and K3 bitunshuffle_tiles. Unlike K4-K6 they hand their
// results to the next stage through device memory: u16 codes from K1, the
// shuffled words and byte flags from K2 (compacted afterwards by torch ops),
// and u16 codes from K3 (dequantized by torch ops).
//
// K1 replaces the Pallas TPU kernel repro/kernels/lorenzo_quant.py:lorenzo_quant
// (float 1-3D -> u16 Lorenzo codes of the same shape). The TPU kernel walks
// bands of leading-axis rows and brings a one-row halo of the previous band
// into VMEM; a 1D input is viewed as rows of 1024 there, a layout detail that
// is not part of the function. Bound: bytes (4n or 2n read, 2n written). What
// keeps it off that bound is the IEEE divide of the pre-quantization
// (__fdiv_rn: a reciprocal refined in several instructions, and a range
// check), so each element is quantized as few times as the CTAs' independence
// allows, into shared memory, and every Lorenzo neighbour is read from there.
// Two steps:
//   * the walk (3-D data whose planes hold at least a tile; 2-D data whose
//     rows do, taken as planes of one row): a CTA owns a run of at most 4096
//     codes inside a plane, r in [r0, r0 + run), and a chunk of consecutive
//     planes. For each plane it quantizes the window [r0 - row - 1, r0 + run)
//     of that plane (2-D: [r0 - 1, ..)) once into one of two buffers; the
//     terms at offsets plane and plane + row are the same window of the
//     previous plane, in the other buffer. The next plane's raw window
//     streams into a third, staging area by 16-byte cp.async while this
//     plane's deltas are made, so no register holds a load in flight (the
//     first form loaded into registers: 48 of them spilled, and each plane
//     waited on its own loads). Thread g makes the deltas of codes r0 + 16 g
//     .. + 15 of each plane: its row, column and gates are the same in every
//     plane, so they are worked out once, and the plane gate (i > 0) is one
//     value a plane. At (100, 500, 500): runs of 4048 codes, 56.9 KB of
//     shared memory and 4 CTAs an SM, so chunks of 13 planes (one wave of
//     496 CTAs) and about 1.21 divides a code;
//   * the tile step (everything else: 1-D data, smaller planes and rows, or
//     rows too long for two windows in shared memory): one CTA a 4096-code
//     tile with K4's windows and codes (fz_windows.cuh's WindowCodes), about
//     1 divide a code in 1-D.
// Both write a group's 16 codes with two 16-byte stores where the group is
// whole and its address aligned (within a plane of the walk: where plane % 8
// == 0), else with 2-byte stores; codes past a plane's end belong to the next
// plane and are not written.
//
// K2 replaces repro/kernels/bitshuffle_flag.py:bitshuffle_flag (u16 tiles ->
// plane-major bitshuffled tiles + one u8 nonzero flag per 8-word block), K3
// replaces :bitunshuffle_tiles (the inverse shuffle). The TPU kernels do the
// 16x16 bit transpose as a 4-stage masked swap on vector lanes. Both keep the
// reference's (e, b) -> (15-b, 15-e) convention, one CTA per 4096-code tile
// in blockIdx order, one 16-code group a thread transposed in registers, and
// are bound by bytes (K2: 2n read, 2n + n/8 written; K3: 2n read, 2n
// written).
//   * K2: thread g loads its group's 16 codes with two 16-byte loads,
//     transposes them (shuffle_group) and stores its 16 words
//     plane-major into a shared tile (word w at w * 256 + g, conflict-free);
//     then each thread writes 16-byte blocks of the tile and their byte flags.
//   * K3: the tile's shuffled words are read into shared memory with 16-byte
//     loads (plane-major as stored: no padding needed, since thread g reads
//     word g of each plane), thread g transposes its group in registers
//     (unshuffle_group, as K6) and writes its 16 codes with two 16-byte
//     stores, so a warp writes 1 KB contiguous.
//
// Build without --use_fast_math. Every entry point launches on the caller's
// stream and returns cudaGetLastError() (or the error of a set-up call).
#include "fz_windows.cuh"

namespace fz {

constexpr int WALK_MIN_CTAS = 4;   // two windows and a staged one, 56 KB at (100, 500, 500):
                                   // 4 CTAs an SM
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a CTA can opt into (H100)

// A group's 16 codes (each below 2**16) as two 16-byte stores.
__device__ __forceinline__ void store16(uint4* dst, const unsigned c[16]) {
  dst[0] = make_uint4(c[0] | c[1] << 16, c[2] | c[3] << 16, c[4] | c[5] << 16, c[6] | c[7] << 16);
  dst[1] = make_uint4(c[8] | c[9] << 16, c[10] | c[11] << 16, c[12] | c[13] << 16,
                      c[14] | c[15] << 16);
}

// The first `valid` codes of a group at out: 16-byte stores where whole and
// aligned, else 2-byte stores.
__device__ __forceinline__ void store_group(uint16_t* out, int valid, const unsigned c[16]) {
  if (valid >= 16 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0) {
    store16(reinterpret_cast<uint4*>(out), c);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (e < valid) out[e] = static_cast<uint16_t>(c[e]);
  }
}

// K1's tile step: one CTA a tile, K4's window codes.
template <bool BF16, int ND>
__global__ void __launch_bounds__(THREADS, WindowCodes<BF16, ND>::MIN_CTAS)
lorenzo_quant_tiles(WindowCodes<BF16, ND> src, uint16_t* __restrict__ codes) {
  extern __shared__ __align__(16) unsigned smem[];
  const int p0 = blockIdx.x * TILE, p = p0 + threadIdx.x * 16;
  unsigned c[16];
  src.codes(smem, p0, threadIdx.x, c);
  if (p < src.n) store_group(codes + p, src.n - p, c);
}

// The walk's layout; the same for every CTA but for its run and chunk. IN:
// in-plane dims (2: 3-D data; 1: 2-D data, a plane being one row). Word 0 of
// a window buffer holds in-plane element r0 - lead, lead = row + 1 (IN 2) or
// 1, so element r0 + 16 g + e - o is at word 16 g + e + lead - o of the
// buffer, word 17 g + padded(e + lead - o) from group g's view (buf + 17 g).
struct Walk {
  int plane;          // in-plane elements
  int row;            // IN 2: elements a row
  int run, runs;      // codes a run (a multiple of 16, at most TILE), runs a plane
  int chunk, planes;  // planes a CTA, planes in all
  int lead;           // row + 1 (IN 2) or 1
  int stride;         // words between the two window buffers
  int mis;            // element 0 is mis elements past a 16-byte boundary
  int col[17];        // 4 * padded(lead + e), e = -1 .. 15: the offset-0 term's reads
};

// Word w of group g's view less the previous plane's word w (PREV).
template <bool PREV>
__device__ __forceinline__ unsigned plane_diff(const char* cur, const char* prev, int bytes) {
  const unsigned v = *reinterpret_cast<const unsigned*>(cur + bytes);
  return PREV ? v - *reinterpret_cast<const unsigned*>(prev + bytes) : v;
}

// A group whose gates are one value throughout: with u the plane difference
// and v(e) = u(c + e) - u(c + e - row) (ROW) or u(c + e), for e = -1 .. 15,
// code e is v(e) - v(e - 1), or v(e) alone where it starts a row (e == e1).
// The offset-0 reads come from the host's table, the row term's are
// constants (4 * padded(1 + e)).
template <bool PREV, bool ROW>
__device__ __forceinline__ void walk_fast(const Walk& w, const char* cur, const char* prev,
                                          int e1, unsigned d[16]) {
  const auto v = [&](int k) {                        // k = e + 1
    const unsigned a = plane_diff<PREV>(cur, prev, w.col[k]);
    return ROW ? a - plane_diff<PREV>(cur, prev, 4 * (k + (k >> 4))) : a;
  };
  unsigned before = v(0);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const unsigned now = v(e + 1);
    d[e] = e == e1 ? now : now - before;
    before = now;
  }
}

// A Lorenzo term gated per code: adds (SUB: subtracts) u(c - o) - u(c - o - 1)
// only where `gate` has the code's bit, without u(c - o - 1) where `km` lacks
// it (a row start); shift = lead - o.
template <bool PREV, bool SUB>
__device__ __forceinline__ void walk_term_gated(const char* cur, const char* prev, int shift,
                                                unsigned gate, unsigned km, unsigned d[16]) {
  unsigned before = plane_diff<PREV>(cur, prev, 4 * padded(shift - 1));
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const unsigned now = plane_diff<PREV>(cur, prev, 4 * padded(shift + e));
    const unsigned t = now - (((km >> e) & 1u) ? before : 0u);
    if ((gate >> e) & 1u) d[e] = SUB ? d[e] - t : d[e] + t;
    before = now;
  }
}

// Group g's deltas in one plane of the walk from its view of the current and
// previous windows. fast: each term's gate is one value for the group, and
// code e1 (16: none) starts a row; else km / jm gate each code.
template <int IN, bool PREV>
__device__ __forceinline__ void walk_deltas(const Walk& w, const char* cur, const char* prev,
                                            bool fast, bool on1, int e1, unsigned km,
                                            unsigned jm, unsigned d[16]) {
  if (IN == 1 || fast) {
    if (IN == 2 && on1) walk_fast<PREV, true>(w, cur, prev, e1, d);
    else walk_fast<PREV, false>(w, cur, prev, e1, d);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) d[e] = 0u;
    walk_term_gated<PREV, false>(cur, prev, w.lead, 0xFFFFu, km, d);
    walk_term_gated<PREV, true>(cur, prev, 1, jm, km, d);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n"); }

// One plane's window of the walk: data elements [s, t), element p at word
// p - base of its buffer, staged as the 16-byte chunks from a0 on (a0 the
// 16-byte boundary at or before s).
struct PlaneWindow {
  int s, t, base, a0, chunks;
};

// The window [lo, hi) of the plane starting at data element `start`; word 0
// holds in-plane element b0.
template <int VEC>
__device__ __forceinline__ PlaneWindow plane_window(int start, int lo, int hi, int b0, int mis) {
  const int s = start + lo, a0 = s - (s + mis) % VEC;
  return {s, start + hi, start + b0, a0, (start + hi - a0 + VEC - 1) / VEC};
}

// Starts copying a plane's window into the staging area: cp.async where the
// chunk lies inside the data, element by element where it crosses 0 or n.
template <bool BF16>
__device__ __forceinline__ void walk_stage(const void* x, int n, const PlaneWindow& pw,
                                           uint4* stage) {
  constexpr int VEC = BF16 ? 8 : 4, ESIZE = BF16 ? 2 : 4;
  const char* xb = static_cast<const char*>(x);
  for (int f = threadIdx.x; f < pw.chunks; f += THREADS) {
    const int e0 = pw.a0 + f * VEC;
    if (e0 >= 0 && e0 + VEC <= n) {
      cp_async16(stage + f, xb + static_cast<long long>(e0) * ESIZE);
    } else {
      char* dst = reinterpret_cast<char*>(stage + f);
      for (int j = 0; j < VEC; ++j)
        if (e0 + j >= 0 && e0 + j < n)
          memcpy(dst + j * ESIZE, xb + static_cast<long long>(e0 + j) * ESIZE, ESIZE);
    }
  }
}

// Pre-quantizes the staged window's elements in [s, t) into buf.
template <bool BF16>
__device__ __forceinline__ void walk_quantize(const PlaneWindow& pw, const uint4* stage,
                                              float two_eb, unsigned* buf) {
  constexpr int VEC = BF16 ? 8 : 4;
  for (int f = threadIdx.x; f < pw.chunks; f += THREADS) {
    const uint4 v = stage[f];
    const unsigned raw[4] = {v.x, v.y, v.z, v.w};
    const int e0 = pw.a0 + f * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float val = BF16 ? widen_bf16((raw[j >> 1] >> (16 * (j & 1))) & 0xFFFFu)
                             : __uint_as_float(raw[j]);
      if (e0 + j >= pw.s && e0 + j < pw.t) buf[padded(e0 + j - pw.base)] = quantize(val, two_eb);
    }
  }
}

// K1's walk: CTA b takes run b % runs of every plane of chunk b / runs. A
// plane's window is staged by cp.async while the previous plane's deltas are
// made, then quantized into buffer i & 1; the other buffer holds plane i - 1.
template <bool BF16, int IN>
__global__ void __launch_bounds__(THREADS, WALK_MIN_CTAS)
lorenzo_quant_walk(const void* __restrict__ x, const float* __restrict__ eb, int zigzag,
                   const Walk w, uint16_t* __restrict__ codes) {
  constexpr int VEC = BF16 ? 8 : 4;
  extern __shared__ __align__(16) unsigned smem[];   // two windows, then the staging
  uint4* stage = reinterpret_cast<uint4*>(smem + 2 * w.stride);
  const int r0 = (blockIdx.x % w.runs) * w.run;
  if (r0 >= w.plane) return;                          // an empty run: the whole CTA
  const int i0 = (blockIdx.x / w.runs) * w.chunk, i1 = min(i0 + w.chunk, w.planes);
  const int n = w.planes * w.plane;
  const int b0 = r0 - w.lead;                         // in-plane element of word 0
  const int lo = max(b0, 0), hi = min(r0 + w.run, w.plane);
  const float two_eb = 2.0f * *eb;

  // group g's place in the plane, the same in every plane
  const int g = threadIdx.x, c0 = r0 + 16 * g;
  bool fast = true, on1 = false;
  int e1 = c0 == 0 ? 0 : 16;
  unsigned km = 0xFFFFu, jm = 0;
  if (IN == 2) {
    int j = c0 / w.row, k = c0 - j * w.row;
    on1 = j > 0;
    e1 = k == 0 ? 0 : min(w.row - k, 16);
    // rows of 16 or more hold at most one row start; the row gate then
    // changes only from row 0 to row 1
    fast = w.row >= 16 && (e1 == 16 || (j + (k > 0) > 0) == on1);
    if (!fast) {
      for (int e = 0; e < 16; ++e) {
        km ^= static_cast<unsigned>(k == 0) << e;
        jm |= static_cast<unsigned>(j > 0) << e;
        if (++k == w.row) {
          k = 0;
          ++j;
        }
      }
    }
  }

  const int first = i0 > 0 ? i0 - 1 : 0;
  walk_stage<BF16>(x, n, plane_window<VEC>(first * w.plane, lo, hi, b0, w.mis), stage);
  for (int i = first; i < i1; ++i) {
    cp_async_wait_all();
    __syncthreads();                                  // plane i staged; plane i - 1 done
    unsigned* cur = smem + (i & 1) * w.stride;
    walk_quantize<BF16>(plane_window<VEC>(i * w.plane, lo, hi, b0, w.mis), stage,
                        two_eb, cur);
    __syncthreads();                                  // window i complete, staging free
    if (i + 1 < i1)
      walk_stage<BF16>(x, n, plane_window<VEC>((i + 1) * w.plane, lo, hi, b0, w.mis),
                       stage);
    if (i >= i0 && c0 < hi) {
      const char* cg = reinterpret_cast<const char*>(cur + 17 * g);
      const char* pg = reinterpret_cast<const char*>(smem + ((i + 1) & 1) * w.stride + 17 * g);
      unsigned d[16];
      if (i > 0) walk_deltas<IN, true>(w, cg, pg, fast, on1, e1, km, jm, d);
      else walk_deltas<IN, false>(w, cg, pg, fast, on1, e1, km, jm, d);
#pragma unroll
      for (int e = 0; e < 16; ++e) d[e] = to_code(static_cast<int>(d[e]), zigzag);
      store_group(codes + i * w.plane + c0, w.plane - c0, d);
    }
  }
}

// K2: one CTA a tile; at most 32 registers, 2048 threads an SM.
__global__ void __launch_bounds__(THREADS, 8)
bitshuffle_flag_tiles(const uint16_t* __restrict__ codes, uint16_t* __restrict__ shuffled,
                      uint8_t* __restrict__ flags) {
  __shared__ __align__(16) uint16_t sh[TILE];        // plane-major
  const int t = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(codes + t * TILE + threadIdx.x * 16);
  const uint4 c0 = __ldg(src), c1 = __ldg(src + 1);
  const unsigned raw[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  unsigned a[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = (raw[e >> 1] >> (16 * (e & 1))) & 0xFFFFu;
  shuffle_group(a);
#pragma unroll
  for (int w = 0; w < 16; ++w) sh[w * GROUPS_PER_TILE + threadIdx.x] = static_cast<uint16_t>(a[w]);
  __syncthreads();

  // block b holds words 8 b .. 8 b + 7 of the tile
  const uint4* blocks = reinterpret_cast<const uint4*>(sh);
  uint4* dst = reinterpret_cast<uint4*>(shuffled + static_cast<long long>(t) * TILE);
  uint8_t* fl = flags + static_cast<long long>(t) * BLOCKS_PER_TILE;
  for (int b = threadIdx.x; b < BLOCKS_PER_TILE; b += THREADS) {
    const uint4 v = blocks[b];
    dst[b] = v;
    fl[b] = (v.x | v.y | v.z | v.w) != 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
bitunshuffle_tiles_k(const uint16_t* __restrict__ shuffled, uint16_t* __restrict__ codes) {
  __shared__ __align__(16) uint16_t sh[TILE];        // plane-major, as stored
  const long long t = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(shuffled + t * TILE);
  for (int i = threadIdx.x; i < TILE / 8; i += THREADS) reinterpret_cast<uint4*>(sh)[i] = src[i];
  __syncthreads();

  unsigned c[16];
  unshuffle_group(sh, threadIdx.x, c);
  store16(reinterpret_cast<uint4*>(codes + t * TILE + threadIdx.x * 16), c);
}

// Sets a kernel's dynamic shared memory above 48 KB where it needs more.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool BF16, int ND>
int launch_tiles(const void* x, int n, int row, int plane, int rows, const float* eb,
                 int zigzag, int mis, uint16_t* codes, cudaStream_t stream) {
  constexpr int VEC = WindowCodes<BF16, ND>::VEC;
  const Windows win = plan_windows(ND == 3 ? MAX_WINDOWS : ND, row, plane, VEC, mis);
  const size_t smem = window_smem(win, VEC);
  const cudaError_t e = allow_smem(lorenzo_quant_tiles<BF16, ND>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  lorenzo_quant_tiles<BF16, ND><<<(n + TILE - 1) / TILE, THREADS, smem, stream>>>(
      WindowCodes<BF16, ND>{x, eb, n, row, plane, rows, zigzag, win}, codes);
  return static_cast<int>(cudaGetLastError());
}

// The walk's layout over `planes` planes of `plane` elements (IN 2: rows of
// `row`), all but its chunk, and in *smem its dynamic shared bytes: two window
// buffers and the staging of one window of `vec`-element chunks.
template <int IN>
Walk plan_walk(int planes, int plane, int row, int mis, int vec, size_t* smem) {
  Walk w{};
  w.plane = plane;
  w.row = row;
  w.planes = planes;
  w.mis = mis;
  w.runs = (plane + TILE - 1) / TILE;
  w.run = ((plane + w.runs - 1) / w.runs + 15) / 16 * 16;
  w.lead = IN == 2 ? row + 1 : 1;
  const int words = w.run + w.lead;                   // elements r0 - lead .. r0 + run
  w.stride = (words + words / 16 + 2) & ~1;           // even: the staging starts on 16 bytes
  for (int e = -1; e < 16; ++e) {
    const int word = w.lead + e;
    w.col[e + 1] = static_cast<int>(sizeof(unsigned)) * (word + (word >> 4));
  }
  const size_t stage_chunks = words / vec + 2;        // a window's 16-byte chunks, at most
  *smem = 2 * sizeof(unsigned) * w.stride + 16 * stage_chunks;
  return w;
}

// The walk over `planes` planes of `plane` elements (IN 2: rows of `row`);
// returns -1 without launching where two windows do not fit in shared memory.
template <bool BF16, int IN>
int launch_walk(const void* x, int planes, int plane, int row, const float* eb, int zigzag,
                int mis, uint16_t* codes, cudaStream_t stream) {
  size_t smem = 0;
  Walk w = plan_walk<IN>(planes, plane, row, mis, BF16 ? 8 : 4, &smem);
  if (smem > MAX_SMEM) return -1;
  const auto kernel = lorenzo_quant_walk<BF16, IN>;
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many chunks as one wave of CTAs holds, each of ceil(planes / chunks) planes
  const int wave = sms * max(per_sm, 1);
  const int chunks = max(1, min(planes, wave / w.runs));
  w.chunk = (planes + chunks - 1) / chunks;
  const int grid = w.runs * ((planes + w.chunk - 1) / w.chunk);
  kernel<<<grid, THREADS, smem, stream>>>(x, eb, zigzag, w, codes);
  return static_cast<int>(cudaGetLastError());
}

// The launch lorenzo_quant makes: the walk where the dims walk and two
// windows fit (true), else the tile step; in *smem its dynamic shared bytes.
inline bool lorenzo_quant_plan(int is_bf16, int ndim, int d0, int d1, int d2, int mis,
                               size_t* smem) {
  const int vec = is_bf16 ? 8 : 4;
  const int row = ndim == 3 ? d2 : d1, plane = d1 * d2;
  *smem = 0;
  if (ndim == 3 && plane >= TILE) plan_walk<2>(d0, plane, row, mis, vec, smem);
  if (ndim == 2 && row >= TILE) plan_walk<1>(d0, row, row, mis, vec, smem);
  if (*smem > 0 && *smem <= MAX_SMEM) return true;
  *smem = window_smem(plan_windows(ndim == 3 ? MAX_WINDOWS : ndim, row, plane, vec, mis), vec);
  return false;
}

template <bool BF16>
int lorenzo_quant(const void* x, int ndim, int d0, int d1, int d2, const float* eb, int zigzag,
                  uint16_t* codes, cudaStream_t stream) {
  const int n = d0 * d1 * d2;
  const int row = ndim == 3 ? d2 : d1, plane = d1 * d2;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x) % 16) / (BF16 ? 2 : 4);
  int rc = -1;
  if (ndim == 3 && plane >= TILE)
    rc = launch_walk<BF16, 2>(x, d0, plane, row, eb, zigzag, mis, codes, stream);
  if (ndim == 2 && row >= TILE)
    rc = launch_walk<BF16, 1>(x, d0, row, row, eb, zigzag, mis, codes, stream);
  if (rc != -1) return rc;
  if (ndim == 1) return launch_tiles<BF16, 1>(x, n, row, plane, d1, eb, zigzag, mis, codes, stream);
  if (ndim == 2) return launch_tiles<BF16, 2>(x, n, row, plane, d1, eb, zigzag, mis, codes, stream);
  return launch_tiles<BF16, 3>(x, n, row, plane, d1, eb, zigzag, mis, codes, stream);
}

}  // namespace fz

extern "C" {

const char* fz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. x: f32 or bf16 (is_bf16, raw bits) data of `ndim` dims (d0, d1, d2),
// row-major, n = d0 * d1 * d2 < 2**31 - 4096. eb: device pointer to the f32
// absolute error bound. codes: u16[n]. Returns a cudaError_t.
int fz_lorenzo_quant(const void* x, int is_bf16, int ndim, long long d0, long long d1,
                     long long d2, const float* eb, int zigzag, uint16_t* codes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int a = static_cast<int>(d0), b = static_cast<int>(d1), c = static_cast<int>(d2);
  return is_bf16 ? fz::lorenzo_quant<true>(x, ndim, a, b, c, eb, zigzag, codes, s)
                 : fz::lorenzo_quant<false>(x, ndim, a, b, c, eb, zigzag, codes, s);
}

// Dynamic shared bytes that fz_lorenzo_quant sets for this data, its element
// 0 `mis` elements past a 16-byte boundary (the walk's or the tile step's).
long long fz_lorenzo_quant_smem(int is_bf16, int ndim, long long d0, long long d1, long long d2,
                                int mis) {
  size_t smem = 0;
  fz::lorenzo_quant_plan(is_bf16, ndim, static_cast<int>(d0), static_cast<int>(d1),
                         static_cast<int>(d2), mis, &smem);
  return static_cast<long long>(smem);
}

// 1 where fz_lorenzo_quant launches the walk for this data, 0 for the tile step.
long long fz_lorenzo_quant_walks(int is_bf16, int ndim, long long d0, long long d1,
                                 long long d2, int mis) {
  size_t smem = 0;
  return fz::lorenzo_quant_plan(is_bf16, ndim, static_cast<int>(d0), static_cast<int>(d1),
                                static_cast<int>(d2), mis, &smem);
}

// K2. codes: u16[n_tiles * 4096], 16-byte aligned. shuffled: u16[n_tiles *
// 4096]; flags: u8[n_tiles * 512]. Returns a cudaError_t.
int fz_bitshuffle_flag(const uint16_t* codes, long long n_tiles, uint16_t* shuffled,
                       uint8_t* flags, void* stream) {
  fz::bitshuffle_flag_tiles<<<static_cast<unsigned>(n_tiles), fz::THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(codes, shuffled, flags);
  return static_cast<int>(cudaGetLastError());
}

// K3. shuffled, codes: u16[n_tiles * 4096], 16-byte aligned. Returns a cudaError_t.
int fz_bitunshuffle_tiles(const uint16_t* shuffled, long long n_tiles, uint16_t* codes,
                          void* stream) {
  fz::bitunshuffle_tiles_k<<<static_cast<unsigned>(n_tiles), fz::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(shuffled, codes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
