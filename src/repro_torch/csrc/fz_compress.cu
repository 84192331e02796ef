// K4 fused_compress and K5 fused_shuffle_encode for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels repro/kernels/fused_compress.py:fused_compress
// (K4: float data -> quantize + Lorenzo + bitshuffle + zero-block flags +
// compaction in one launch) and :fused_shuffle_encode (K5: the same on given
// u16 codes, the reference's strict-mode route). Output: packed flags
// u32[16 * tiles], payload u16[capacity, 8], nnz i32. K4's payload is zeroed
// by the caller; K5 writes every block of its payload, zero past nnz, as the
// TPU kernel zeroes it in its body. Strict K4 (WindowCodesStrict) also writes
// the exact outlier channel, so strict mode is one launch here, where the
// reference runs dual_quantize's jnp ops and then K5.
//
// Bound: bytes. The input is read once, the flags and the payload written
// once; the function needs one divide per element (K4) and a few dozen
// integer operations per code, far below the card's rate.
//
// K4. One CTA per 4096-code tile of the flat code stream, tiles handed out
// in ticket order. The TPU kernel walks the stream sequentially and carries a
// code remainder and the payload offset across grid steps; CTAs on the card
// run in no order, so here
//   * K4 brings the tile's Lorenzo neighbourhood into shared memory: the
//     neighbours of codes [p0, p0 + 4096) at offset o in {0, row, plane,
//     plane + row} (as many as the dims have) lie in the window [p0 - o - 1,
//     p0 - o + 4096). Overlapping windows are merged (at (100, 500, 500): two
//     of 4597 elements) and every element of them is pre-quantized once, read
//     with 16-byte loads over a chunk-aligned superset, and kept as a 32-bit
//     word. The layout is the same for every tile, so the host computes it
//     once per call (Windows, fz_windows.cuh, shared with K1's tile step) and
//     sizes the dynamic shared memory to it (at most 17,443 words with the
//     padding, 69.8 KB). No carry between tiles:
//     about 2.2 divides a code at (100, 500, 500), where quantizing each
//     neighbour from the input took up to 8;
//   * one 16-code group a thread: thread g makes the Lorenzo deltas of codes
//     16 g .. 16 g + 15 from the windows, each neighbour row read once for
//     the group (17 words). Its row, plane and column are divided out once;
//     where each neighbour term is on or off for the whole group (rows of 16
//     or more hold at most one row start, and the row and plane gates do not
//     change there: all but the first row of each plane), a term costs one
//     shared load and one add a code, and the row start is mended after;
//     other groups gate each code. The deltas become codes, and the group is
//     transposed in registers (shuffle_group); the 16 words go plane-major
//     into the shared tile, a conflict-free store;
//   * the payload offset of a tile is the exclusive prefix of the tiles'
//     non-zero block counts, from a single-pass decoupled look-back scan.
// The window buffer is padded by one word every 16 (fz_windows.cuh). The
// shuffled tile reuses the start of the buffer once every thread has made its
// codes.
//
// Strict K4: the same launch, with the outlier channel of
// core/quant.py:dual_quantize (the first K overflowing deltas in flat order,
// each slot the flat index and the residual against the saturated code).
// Each thread tests its 16 raw deltas before they become codes; a tile with
// no overflow (a block-wide OR at the barrier that ends the window reads)
// does nothing more. Otherwise each overflowing residual waits in shared
// memory past the shuffled tile, and a warp scan and the warps' totals give
// each group its overflows before it in the tile. The tile's place in the
// channel is a second decoupled look-back, over the tiles' overflow counts,
// published beside the block count's so neither chain waits on the other;
// each group then writes its overflows while there are slots. The last tile
// writes the uncapped count, as it writes nnz.
//
// K5. One CTA a tile in ticket order, as K4, with these differences:
//   * two adjacent 16-code groups a thread, 128 threads a tile: 16 tiles in
//     flight an SM where one group a thread fits 8 (the kernel waits on its
//     loads, barriers and look-back more than it computes);
//   * the codes are four 16-byte loads a thread (codes that do not start on
//     16 bytes pass through shared memory by coalesced 2-byte loads), kept
//     two to a register, and the 16x16 bit transpose moves two row pairs a
//     masked swap (shuffle_pairs): about 130 operations a group where
//     shuffle_group takes about 220; word w of the two groups leaves as one
//     4-byte store;
//   * flags from registers: block b of the plane-major tile is word b / 32 of
//     8 consecutive groups, so its flag is an OR across 4 lanes of a warp,
//     not a read pass over the tile;
//   * the payload is written once, in the kernel: every block of a tile
//     makes one 16-byte store, its words if flagged, else a zero into the
//     tile's run of the payload's zero tail (shuffle_encode_tiles). No
//     separate pass zeroes the payload, and no CTA waits for nnz.
// A co-resident grid of persistent CTAs (a cooperative launch, each CTA
// taking tiles in turn with the next tile's codes in flight by cp.async and
// the zero tail written once nnz was known) measured slower than one CTA a
// tile on the card (PERF.md, section 6).
//
// Exactness: the pre-quantization is fz_common.cuh's quantize (a true IEEE
// divide, round half to even, converted as XLA does), the deltas wrap in
// unsigned 32-bit arithmetic, bf16 widens by its raw bits; K1 computes the
// same codes (fz_staged.cu), and chip_smoke.py holds both against their plain
// versions. Build without --use_fast_math.
#include "fz_windows.cuh"

namespace fz {

// Strict K4's two look-backs, flagged blocks (st) and overflows (ost), with
// both aggregates published before either chain is read. Called by all
// threads; `agg` and `oagg` must be valid in warp 0. Returns the exclusive
// block prefix; `oexcl` gets the exclusive overflow prefix.
__device__ unsigned scan_blocks_and_overflows(unsigned long long* st, unsigned long long* ost,
                                              long long seg, unsigned agg, unsigned oagg,
                                              unsigned& oexcl) {
  __shared__ unsigned s_excl[2];
  if (threadIdx.x < 32) {
    unsigned excl = 0, oex = 0;
    if (seg == 0) {
      if (threadIdx.x == 0) {
        publish(st, 0, ST_PREFIX, agg);
        publish(ost, 0, ST_PREFIX, oagg);
      }
    } else {
      if (threadIdx.x == 0) {
        publish(st, seg, ST_AGGREGATE, agg);
        publish(ost, seg, ST_AGGREGATE, oagg);
      }
      excl = lookback_exclusive(st, seg, 0);
      if (threadIdx.x == 0) publish(st, seg, ST_PREFIX, excl + agg);
      oex = lookback_exclusive(ost, seg, 0);
      if (threadIdx.x == 0) publish(ost, seg, ST_PREFIX, oex + oagg);
    }
    if (threadIdx.x == 0) {
      s_excl[0] = excl;
      s_excl[1] = oex;
    }
  }
  __syncthreads();
  oexcl = s_excl[1];
  return s_excl[0];
}

// Src: WindowCodes (paper) or WindowCodesStrict (the outlier channel too).
template <typename Src>
__global__ void __launch_bounds__(THREADS, Src::MIN_CTAS)
encode_tiles(Src src, uint32_t* __restrict__ bitflags, uint16_t* __restrict__ payload,
             long long capacity, int* __restrict__ nnz, unsigned long long* st,
             unsigned* ticket, int n_tiles) {
  extern __shared__ __align__(16) unsigned smem[];   // K4's windows, then the tile
  uint16_t* sh = reinterpret_cast<uint16_t*>(smem);  // shuffled tile, plane-major
  __shared__ uint32_t fw[FLAG_WORDS_PER_TILE];
  const int t = static_cast<int>(take_ticket(ticket));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // codes + bitshuffle: thread g takes group g
  unsigned a[16];
  [[maybe_unused]] unsigned om = 0, o_before = 0, o_agg = 0;   // strict: the overflows
  if constexpr (Src::STRICT) {
    // the raw deltas first: code e of group g overflows if bit e of om is set;
    // its residual waits in shared memory past the shuffled tile (word
    // 16 g + e) until the tile's place in the channel is known
    src.template codes<true>(smem, t * TILE, threadIdx.x, a);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      om |= static_cast<unsigned>(code_overflows(static_cast<int>(a[e]), src.zigzag)) << e;
    unsigned* resid = smem + TILE / 2;
    if (__syncthreads_or(om != 0u)) {                // every window read is done
      __shared__ unsigned s_warp[WARPS];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if ((om >> e) & 1u)
          resid[16 * threadIdx.x + e] =
              static_cast<unsigned>(code_residual(static_cast<int>(a[e]), src.zigzag));
      const unsigned cnt = __popc(om);
      unsigned incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned v = s_warp[w];
        o_agg += v;
        o_before += w < warp ? v : 0u;
      }
      o_before += incl - cnt;                        // overflows of the tile before group g
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = to_code(static_cast<int>(a[e]), src.zigzag);
    shuffle_group(a);
  } else {
    src.codes(smem, t * TILE, threadIdx.x, a);
    shuffle_group(a);
    __syncthreads();                                 // every window read is done
  }
#pragma unroll
  for (int w = 0; w < 16; ++w) sh[w * GROUPS_PER_TILE + threadIdx.x] = static_cast<uint16_t>(a[w]);
  __syncthreads();

  // zero-block flags, packed least significant bit first
  const uint4* blocks = reinterpret_cast<const uint4*>(sh);
  for (int b = threadIdx.x; b < BLOCKS_PER_TILE; b += THREADS) {
    const uint4 v = blocks[b];
    const unsigned bal = __ballot_sync(0xffffffffu, (v.x | v.y | v.z | v.w) != 0u);
    if (lane == 0) fw[b >> 5] = bal;
  }
  __syncthreads();

  unsigned agg = 0;
  if (warp == 0) agg = warp_sum(lane < FLAG_WORDS_PER_TILE ? __popc(fw[lane]) : 0u);
  unsigned base;
  if constexpr (Src::STRICT) {
    unsigned obase;
    base = scan_blocks_and_overflows(st, src.ost, t, agg, o_agg, obase);
    if (threadIdx.x == 0 && t == n_tiles - 1) {
      *nnz = static_cast<int>(base + agg);
      *src.n_over = static_cast<int>(obase + o_agg);
    }
    // the channel: the group's overflows in order from its place in the
    // stream's, while there are slots
    unsigned m = om;
    long long r = static_cast<long long>(obase) + o_before;
    const unsigned* resid = smem + TILE / 2;
    for (; m != 0u && r < src.ocap; m &= m - 1u, ++r) {
      const int e = __ffs(m) - 1;
      src.idx[r] = t * TILE + 16 * static_cast<int>(threadIdx.x) + e;
      src.val[r] = static_cast<int>(resid[16 * threadIdx.x + e]);
    }
  } else {
    base = scan_segment(st, t, 0, agg);
    if (threadIdx.x == 0 && t == n_tiles - 1) *nnz = static_cast<int>(base + agg);
  }
  if (threadIdx.x < FLAG_WORDS_PER_TILE)
    bitflags[static_cast<long long>(t) * FLAG_WORDS_PER_TILE + threadIdx.x] = fw[threadIdx.x];

  // compaction: flagged blocks in order at base + local exclusive count
  uint4* out = reinterpret_cast<uint4*>(payload);
  for (int b = threadIdx.x; b < BLOCKS_PER_TILE; b += THREADS) {
    if ((fw[b >> 5] >> (b & 31)) & 1u) {
      const long long off = static_cast<long long>(base) + flags_before(fw, b);
      if (off < capacity) out[off] = blocks[b];
    }
  }
}

template <typename Src>
int launch(const Src& src, size_t smem, int n_tiles, uint32_t* bitflags, uint16_t* payload,
           long long capacity, int* nnz, unsigned long long* scratch, cudaStream_t stream) {
  // scratch: n_tiles look-back words, then the ticket; zeroed by the caller
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + n_tiles);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        encode_tiles<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  encode_tiles<Src><<<n_tiles, THREADS, smem, stream>>>(src, bitflags, payload, capacity,
                                                        nnz, scratch, ticket, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// -- K5 -------------------------------------------------------------------

// shuffle_group on codes as loaded, two to a register (code 2 i in the low
// half of raw[i]), leaving words 2 q (low half) and 2 q + 1 (high half) in
// p[q]: the bit matrix's rows 2 q and 2 q + 1 are the halves of the 32-bit
// reversal of raw[7 - q], and each masked swap of transpose16 moves two row
// pairs at once (the stage of distance 1 swaps within a register). About
// 130 operations a group, where shuffle_group takes about 220.
__device__ __forceinline__ void shuffle_pairs(const unsigned raw[8], unsigned p[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) p[q] = __brev(raw[7 - q]);
#pragma unroll
  for (int j = 8, m = 0x00FF; j != 1; j >>= 1, m ^= m << j) {
    const unsigned mm = static_cast<unsigned>(m) | (static_cast<unsigned>(m) << 16);
    const int h = j >> 1;                      // rows k, k + j are registers q, q + h
#pragma unroll
    for (int q = 0; q < 8; q = ((q | h) + 1) & ~h) {
      const unsigned t = ((p[q] >> j) ^ p[q + h]) & mm;
      p[q + h] ^= t;
      p[q] ^= t << j;
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {                // distance 1: low and high halves
    const unsigned t = ((p[q] >> 1) ^ (p[q] >> 16)) & 0x5555u;
    p[q] ^= (t << 16) | (t << 1);
  }
}

constexpr int K5_THREADS = THREADS / 2;   // two adjacent groups a thread
constexpr int K5_WARPS = K5_THREADS / 32;

// K5: one CTA a tile, in ticket order; thread i takes groups 2 i and 2 i + 1,
// so 16 CTAs (tiles) are in flight an SM where one group a thread fits 8.
// Every block of the tile writes one payload block: a flagged block its words
// at the count of flagged blocks before it; a zero block a zero at zeros + the
// zero blocks before it in the tile. Tiles t .. n - 1 compact at most
// 512 (n - t) blocks from tile t's offset, so [zeros, zeros + the tile's zero
// blocks), zeros = its inclusive prefix + 512 (n - 1 - t), is never compacted
// into: the tiles' zero runs tile [nnz, 512 n) in reverse order, and the
// payload is written once.
template <bool ALIGNED>
__global__ void __launch_bounds__(K5_THREADS, 16)
shuffle_encode_tiles(const uint16_t* __restrict__ codes, uint32_t* __restrict__ bitflags,
                     uint16_t* __restrict__ payload, long long capacity,
                     int* __restrict__ nnz, unsigned long long* st, unsigned* ticket,
                     int n_tiles) {
  __shared__ __align__(16) uint16_t sh[TILE];        // shuffled tile, plane-major
  __shared__ uint32_t fws[FLAG_WORDS_PER_TILE];      // packed flags
  __shared__ uint32_t before[FLAG_WORDS_PER_TILE];   // set flags in the words before
  __shared__ uint8_t bits[FLAG_WORDS_PER_TILE][K5_WARPS];  // bits 8 W .. 8 W + 7 of word w
  __shared__ unsigned s_base;
  const int t = static_cast<int>(take_ticket(ticket));
  const int i = threadIdx.x, warp = i >> 5, lane = i & 31;
  const int g0 = 2 * i;                              // groups g0 and g0 + 1
  const uint16_t* tile_codes = codes + static_cast<long long>(t) * TILE;

  // codes, two to a register: 64 bytes a thread, as four 16-byte loads; codes
  // that do not start on 16 bytes pass through the shared tile by coalesced
  // 2-byte loads first
  uint4 c[4];
  if (!ALIGNED) {
    for (int e = i; e < TILE; e += K5_THREADS) sh[e] = tile_codes[e];
    __syncthreads();
  }
  const uint4* from = ALIGNED ? reinterpret_cast<const uint4*>(tile_codes) + 2 * g0
                              : reinterpret_cast<const uint4*>(sh) + 2 * g0;
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] = ALIGNED ? __ldg(from + k) : from[k];
  if (!ALIGNED) __syncthreads();                     // the tile is free for the shuffled words
  const unsigned raw0[8] = {c[0].x, c[0].y, c[0].z, c[0].w, c[1].x, c[1].y, c[1].z, c[1].w};
  const unsigned raw1[8] = {c[2].x, c[2].y, c[2].z, c[2].w, c[3].x, c[3].y, c[3].z, c[3].w};
  unsigned p0[8], p1[8];                             // words 2 q, 2 q + 1 of each group
  shuffle_pairs(raw0, p0);
  shuffle_pairs(raw1, p1);

  // zero-block flags from registers: bit w of m is block 32 w + g0 / 8, ORed
  // over the 4 lanes (8 groups) of that block
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned v = p0[q] | p1[q];
    m |= ((v & 0xFFFFu) != 0u ? 1u : 0u) << (2 * q) | (v > 0xFFFFu ? 2u : 0u) << (2 * q);
  }
  m |= __shfl_xor_sync(0xffffffffu, m, 1);
  m |= __shfl_xor_sync(0xffffffffu, m, 2);
  unsigned byte = 0;                     // lane w < 16: word w's 8 bits of this warp
#pragma unroll
  for (int k = 0; k < 8; ++k) byte |= ((__shfl_sync(0xffffffffu, m, 4 * k) >> (lane & 15)) & 1u) << k;
  if (lane < FLAG_WORDS_PER_TILE) bits[lane][warp] = static_cast<uint8_t>(byte);
  // word w of groups g0 and g0 + 1 side by side: one 4-byte store
  uint32_t* sh32 = reinterpret_cast<uint32_t*>(sh);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    sh32[(2 * q * GROUPS_PER_TILE + g0) >> 1] = __byte_perm(p0[q], p1[q], 0x5410);
    sh32[((2 * q + 1) * GROUPS_PER_TILE + g0) >> 1] = __byte_perm(p0[q], p1[q], 0x7632);
  }
  __syncthreads();

  // warp 0: the packed flags, their prefix and the look-back
  if (warp == 0) {
    uint32_t fw = 0;
    if (lane < FLAG_WORDS_PER_TILE) {
#pragma unroll
      for (int v = 0; v < K5_WARPS; ++v) fw |= static_cast<uint32_t>(bits[lane][v]) << (8 * v);
    }
    const unsigned cnt = __popc(fw);
    unsigned incl = cnt;
#pragma unroll
    for (int o = 1; o < FLAG_WORDS_PER_TILE; o <<= 1) {
      const unsigned x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    const unsigned agg = __shfl_sync(0xffffffffu, incl, FLAG_WORDS_PER_TILE - 1);
    if (lane < FLAG_WORDS_PER_TILE) {
      fws[lane] = fw;
      before[lane] = incl - cnt;
      bitflags[static_cast<long long>(t) * FLAG_WORDS_PER_TILE + lane] = fw;
    }
    unsigned excl = 0;
    if (t == 0) {
      if (lane == 0) publish(st, 0, ST_PREFIX, agg);
    } else {
      if (lane == 0) publish(st, t, ST_AGGREGATE, agg);
      excl = lookback_exclusive(st, t, 0);
      if (lane == 0) publish(st, t, ST_PREFIX, excl + agg);
    }
    if (lane == 0) {
      s_base = excl;
      if (t == n_tiles - 1) *nnz = static_cast<int>(excl + agg);
    }
  }
  __syncthreads();

  // compaction and the tile's zero run, one 16-byte store a block
  const uint4* blocks = reinterpret_cast<const uint4*>(sh);
  uint4* out = reinterpret_cast<uint4*>(payload);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long whole = static_cast<long long>(n_tiles) * BLOCKS_PER_TILE;
  const long long base = s_base;
  const long long zeros = base + before[FLAG_WORDS_PER_TILE - 1] +
                          __popc(fws[FLAG_WORDS_PER_TILE - 1]) +
                          (whole - static_cast<long long>(t + 1) * BLOCKS_PER_TILE);
  for (int b = i; b < BLOCKS_PER_TILE; b += K5_THREADS) {
    const uint32_t fw = fws[b >> 5];
    const int set = static_cast<int>(before[b >> 5]) + __popc(fw & ((1u << (b & 31)) - 1u));
    const bool on = (fw >> (b & 31)) & 1u;
    const long long at = on ? base + set : zeros + (b - set);
    const uint4 v = blocks[b];
    if (at < capacity) out[at] = on ? v : zero;
  }
  // a capacity past 512 n: tile t zeroes its share of [512 n, capacity)
  if (capacity > whole) {
    const long long share = (capacity - whole + n_tiles - 1) / n_tiles;
    const long long hi = min(capacity, whole + (t + 1) * share);
    for (long long c = whole + t * share + i; c < hi; c += K5_THREADS) out[c] = zero;
  }
}

}  // namespace fz

namespace {

// K4's source for paper mode (no outlier channel) or strict mode (a Channel).
struct NoChannel {};
struct Channel {
  int* idx;
  int* val;
  long long ocap;
  int* n_over;
};

template <bool BF, int ND>
fz::WindowCodes<BF, ND> source(const fz::WindowCodes<BF, ND>& codes, NoChannel,
                               unsigned long long*) {
  return codes;
}

template <bool BF, int ND>
fz::WindowCodesStrict<BF, ND> source(const fz::WindowCodes<BF, ND>& codes, const Channel& ch,
                                     unsigned long long* ost) {
  return {codes, ch.idx, ch.val, ch.ocap, ch.n_over, ost};
}

// K4's dynamic shared bytes: the windows.
size_t k4_smem(const fz::Windows& win, int vec, NoChannel) { return fz::window_smem(win, vec); }

// Strict K4's: the windows, or the shuffled tile (TILE / 2 words) and the
// residuals' stash (TILE words) after them, whichever is more.
size_t k4_smem(const fz::Windows& win, int vec, const Channel&) {
  const size_t stash = sizeof(unsigned) * (fz::TILE / 2 + fz::TILE);
  const size_t windows = fz::window_smem(win, vec);
  return windows > stash ? windows : stash;
}

// The windows both K4 entries plan for the data.
fz::Windows k4_windows(int ndim, long long d1, long long d2, int vec, int mis) {
  const int row = static_cast<int>(ndim == 3 ? d2 : d1), plane = static_cast<int>(d1 * d2);
  return fz::plan_windows(ndim == 3 ? 4 : ndim, row, plane, vec, mis);
}

// Both K4 entries: the data's geometry and the dispatch over dtype and rank.
template <typename Ch>
int fused_compress(const void* x, int is_bf16, int ndim, long long d0, long long d1,
                   long long d2, const float* eb, int zigzag, uint32_t* bitflags,
                   uint16_t* payload, long long capacity, int* nnz, const Ch& ch,
                   unsigned long long* scratch, void* stream) {
  const int n = static_cast<int>(d0 * d1 * d2);
  const int n_tiles = (n + fz::TILE - 1) / fz::TILE;
  const int row = static_cast<int>(ndim == 3 ? d2 : d1);
  const int plane = static_cast<int>(d1 * d2);
  const int rows = static_cast<int>(d1);
  const int esize = is_bf16 ? 2 : 4, vec = 16 / esize;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x) % 16) / esize;
  const fz::Windows win = k4_windows(ndim, d1, d2, vec, mis);
  const size_t smem = k4_smem(win, vec, ch);
  unsigned long long* ost = scratch + n_tiles + 1;   // past the block look-back and the ticket
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FZ_K4(BF, ND)                                                                     \
  return fz::launch(source(fz::WindowCodes<BF, ND>{x, eb, n, row, plane, rows, zigzag, win}, \
                           ch, ost),                                                       \
                    smem, n_tiles, bitflags, payload, capacity, nnz, scratch, s)
  if (is_bf16) {
    if (ndim == 1) FZ_K4(true, 1);
    if (ndim == 2) FZ_K4(true, 2);
    FZ_K4(true, 3);
  }
  if (ndim == 1) FZ_K4(false, 1);
  if (ndim == 2) FZ_K4(false, 2);
  FZ_K4(false, 3);
#undef FZ_K4
}

template <typename Ch>
long long fused_compress_smem(int is_bf16, int ndim, long long d1, long long d2, int mis) {
  const int vec = is_bf16 ? 8 : 4;
  return static_cast<long long>(k4_smem(k4_windows(ndim, d1, d2, vec, mis), vec, Ch{}));
}

}  // namespace

extern "C" {

const char* fz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4. x: f32 or bf16 (is_bf16, raw bits) data of `ndim` dims (d0, d1, d2),
// row-major, n = d0 * d1 * d2 < 2**31 - 4096. eb: device pointer to the f32
// absolute error bound. Returns a cudaError_t.
int fz_fused_compress(const void* x, int is_bf16, int ndim, long long d0, long long d1,
                      long long d2, const float* eb, int zigzag, uint32_t* bitflags,
                      uint16_t* payload, long long capacity, int* nnz,
                      unsigned long long* scratch, void* stream) {
  return fused_compress(x, is_bf16, ndim, d0, d1, d2, eb, zigzag, bitflags, payload, capacity,
                        nnz, NoChannel{}, scratch, stream);
}

// Strict K4: fz_fused_compress with the exact outlier channel. idx, val:
// i32[ocap], prefilled with n and 0 by the caller; n_over: the uncapped
// overflow count. scratch: 2 n_tiles + 1 words, zeroed by the caller.
int fz_fused_compress_strict(const void* x, int is_bf16, int ndim, long long d0, long long d1,
                             long long d2, const float* eb, int zigzag, uint32_t* bitflags,
                             uint16_t* payload, long long capacity, int* nnz, int* idx,
                             int* val, long long ocap, int* n_over,
                             unsigned long long* scratch, void* stream) {
  return fused_compress(x, is_bf16, ndim, d0, d1, d2, eb, zigzag, bitflags, payload, capacity,
                        nnz, Channel{idx, val, ocap, n_over}, scratch, stream);
}

// Dynamic shared bytes that fz_fused_compress sets for this data, its
// element 0 `mis` elements past a 16-byte boundary.
long long fz_fused_compress_smem(int is_bf16, int ndim, long long d0, long long d1, long long d2,
                                 int mis) {
  return fused_compress_smem<NoChannel>(is_bf16, ndim, d1, d2, mis);
}

// The same for fz_fused_compress_strict.
long long fz_fused_compress_strict_smem(int is_bf16, int ndim, long long d0, long long d1,
                                        long long d2, int mis) {
  return fused_compress_smem<Channel>(is_bf16, ndim, d1, d2, mis);
}

// K5. codes: u16[n_tiles * 4096]. payload: every block written (zero past
// nnz). scratch: n_tiles look-back words, then the ticket; zeroed by the
// caller. Returns a cudaError_t.
int fz_fused_shuffle_encode(const uint16_t* codes, long long n_tiles, uint32_t* bitflags,
                            uint16_t* payload, long long capacity, int* nnz,
                            unsigned long long* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + n_tiles);
  const unsigned grid = static_cast<unsigned>(n_tiles);
  const int tiles = static_cast<int>(n_tiles);
  if (reinterpret_cast<uintptr_t>(codes) % 16 == 0)
    fz::shuffle_encode_tiles<true><<<grid, fz::K5_THREADS, 0, s>>>(codes, bitflags, payload,
                                                                 capacity, nnz, scratch,
                                                                 ticket, tiles);
  else
    fz::shuffle_encode_tiles<false><<<grid, fz::K5_THREADS, 0, s>>>(codes, bitflags, payload,
                                                                  capacity, nnz, scratch,
                                                                  ticket, tiles);
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of K5 the current card runs at once: one wave of tiles, or
// -1 on a CUDA error.
long long fz_fused_shuffle_encode_ctas() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fz::shuffle_encode_tiles<true>,
                                                      fz::K5_THREADS, 0);
  return e == cudaSuccess ? static_cast<long long>(sms) * per_sm : -1;
}

}  // extern "C"
