// Shared pieces of the FZ kernels for Hopper (sm_90a): stream geometry, the
// quantization of one element and its saturating code, the 16x16 bit
// transpose (in registers, one 16-code group a thread, for K2-K6), and a
// single-pass decoupled look-back scan across CTAs. The Lorenzo codes from
// pre-quantized windows (K1, K4) are in fz_windows.cuh.
//
// Bit convention (the reference's, repro/core/shuffle.py): bit b of element e
// of a 16-code group lands in bit 15-e of word 15-b, and a tile's words are
// stored plane-major (word w of group g at w*256 + g).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fz {

constexpr int TILE = 4096;                 // codes per shuffle tile
constexpr int GROUPS_PER_TILE = 256;       // 16-code groups per tile
constexpr int BLOCK_WORDS = 8;             // u16 words per zero block
constexpr int BLOCKS_PER_TILE = 512;
constexpr int FLAG_WORDS_PER_TILE = 16;    // packed u32 flag words per tile
constexpr int THREADS = 256;               // threads per CTA
constexpr int WARPS = THREADS / 32;

// Look-back status word: status in bits 32..33, 32-bit value below.
constexpr unsigned long long ST_AGGREGATE = 1ull << 32;   // own sum only
constexpr unsigned long long ST_PREFIX = 2ull << 32;      // inclusive prefix

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One 64-bit atomic store carries both the status and the value, and readers
// take nothing else from a publisher, so no fence is needed before it.
__device__ __forceinline__ void publish(unsigned long long* st, long long i,
                                        unsigned long long status, unsigned v) {
  atomicExch(st + i, status | v);
}

// Exclusive prefix of the values published by segments [first, seg), summed
// modulo 2**32. Called by all 32 lanes of one warp; every lane gets the sum.
// Segments are handed out in ticket order, so every predecessor is resident
// or done and the spin below always ends.
__device__ unsigned lookback_exclusive(unsigned long long* st, long long seg,
                                       long long first) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  long long end = seg - 1;
  while (true) {
    const long long j = end - lane;
    unsigned long long s = ST_PREFIX;
    if (j >= first) s = *reinterpret_cast<volatile unsigned long long*>(st + j);
    const unsigned status = static_cast<unsigned>(s >> 32);
    const unsigned invalid = __ballot_sync(0xffffffffu, status == 0);
    const unsigned prefix = __ballot_sync(0xffffffffu, status == 2);
    // lanes up to and including the nearest inclusive prefix
    const unsigned window = prefix ? (prefix ^ (prefix - 1)) : 0xffffffffu;
    if (invalid & window) continue;   // a predecessor has not published yet
    excl += warp_sum(((window >> lane) & 1u) ? static_cast<unsigned>(s) : 0u);
    if (prefix) return excl;
    end -= 32;
  }
}

// Takes the next segment in ticket order (thread 0), publishes this CTA's
// aggregate, looks back (warp 0) and publishes the inclusive prefix. Called
// by all threads; returns the exclusive prefix. `agg` must be valid in warp 0.
__device__ unsigned scan_segment(unsigned long long* st, long long seg,
                                 long long first, unsigned agg) {
  __shared__ unsigned s_excl;
  if (threadIdx.x < 32) {
    unsigned excl = 0;
    if (seg == first) {
      if (threadIdx.x == 0) publish(st, seg, ST_PREFIX, agg);
    } else {
      if (threadIdx.x == 0) publish(st, seg, ST_AGGREGATE, agg);
      excl = lookback_exclusive(st, seg, first);
      if (threadIdx.x == 0) publish(st, seg, ST_PREFIX, excl + agg);
    }
    if (threadIdx.x == 0) s_excl = excl;
  }
  __syncthreads();
  return s_excl;
}

// The segmented form (K6's row scan, resetting at every row start): a segment
// holding a row start publishes the sum after its last start as an inclusive
// prefix at once, since nothing before that start reaches past it; if it
// begins mid-row it still looks back for the carry into its leading part. A
// segment with no start chains as in scan_segment. Returns the carry (the
// running row sum just before the segment; 0 if it begins a row). `agg` and
// `has_start` must be valid in warp 0; segment 0 must hold a start.
__device__ unsigned scan_segment_rows(unsigned long long* st, long long seg, unsigned agg,
                                      bool has_start, bool mid_row) {
  __shared__ unsigned s_carry;
  if (threadIdx.x < 32) {
    unsigned carry = 0;
    if (has_start) {
      if (threadIdx.x == 0) publish(st, seg, ST_PREFIX, agg);
      if (mid_row) carry = lookback_exclusive(st, seg, 0);
    } else {
      if (threadIdx.x == 0) publish(st, seg, ST_AGGREGATE, agg);
      carry = lookback_exclusive(st, seg, 0);
      if (threadIdx.x == 0) publish(st, seg, ST_PREFIX, carry + agg);
    }
    if (threadIdx.x == 0) s_carry = carry;
  }
  __syncthreads();
  return s_carry;
}

__device__ __forceinline__ long long take_ticket(unsigned* ticket) {
  __shared__ long long s_seg;
  if (threadIdx.x == 0) s_seg = atomicAdd(ticket, 1u);
  __syncthreads();
  return s_seg;
}

// The 16x16 bit transpose of a group held in registers, in 4 rounds of
// masked swaps (a transpose is its own inverse).
__device__ __forceinline__ void transpose16(unsigned a[16]) {
#pragma unroll
  for (int j = 8, m = 0x00FF; j != 0; j >>= 1, m ^= m << j) {
#pragma unroll
    for (int k = 0; k < 16; k = ((k | j) + 1) & ~j) {
      const unsigned t = ((a[k] >> j) ^ a[k + j]) & static_cast<unsigned>(m);
      a[k + j] ^= t;
      a[k] ^= t << j;
    }
  }
}

// One thread's 16-code group -> its 16 words (bit planes), in registers and
// in place: row 15 - e of the bit matrix is the 16-bit reversal of code e,
// and word w is row w of its transpose. About 12 operations a code.
__device__ __forceinline__ void shuffle_group(unsigned a[16]) {
  unsigned r[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) r[15 - e] = __brev(a[e]) >> 16;
  transpose16(r);
#pragma unroll
  for (int w = 0; w < 16; ++w) a[w] = r[w];
}

// The inverse: group g's 16 words from a plane-major tile (word w at
// w * GROUPS_PER_TILE + g) -> its 16 codes; code e is the 16-bit reversal of
// transposed row 15 - e.
__device__ __forceinline__ void unshuffle_group(const uint16_t* tile_words, int g,
                                                unsigned code[16]) {
  unsigned a[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) a[w] = tile_words[w * GROUPS_PER_TILE + g];
  transpose16(a);
#pragma unroll
  for (int e = 0; e < 16; ++e) code[e] = __brev(a[15 - e]) >> 16;
}

// Saturating u16 code of an int32 Lorenzo delta: sign-magnitude (<= 0x7FFF)
// or zigzag (<= 0xFFFF), as the reference's to_codes.
__device__ __forceinline__ unsigned to_code(int d, int zigzag) {
  if (!zigzag) {
    const int mag = d < 0 ? static_cast<int>(0u - static_cast<unsigned>(d)) : d;
    const int sat = min(mag, 0x7FFF);
    return (static_cast<unsigned>(sat) & 0xFFFFu) | (d < 0 ? 0x8000u : 0u);
  }
  const int z = static_cast<int>((static_cast<unsigned>(d) << 1) ^
                                 static_cast<unsigned>(d >> 31));
  return static_cast<unsigned>(min(z, 0xFFFF)) & 0xFFFFu;
}

// Pre-quantization of one element: a true IEEE divide (__fdiv_rn, no
// --use_fast_math), rounded half to even and converted as XLA does (out of
// range saturates, NaN gives 0: __float2int_rn), as the reference.
__device__ __forceinline__ unsigned quantize(float v, float two_eb) {
  return static_cast<unsigned>(__float2int_rn(__fdiv_rn(v, two_eb)));
}

// BF16 raw bits widened exactly to float.
__device__ __forceinline__ float widen_bf16(unsigned bits) { return __uint_as_float(bits << 16); }

// Exclusive count of set flags before block b of a tile's packed flags.
__device__ __forceinline__ unsigned flags_before(const uint32_t* fw, int b) {
  unsigned c = __popc(fw[b >> 5] & ((1u << (b & 31)) - 1u));
  for (int i = 0; i < (b >> 5); ++i) c += __popc(fw[i]);
  return c;
}

}  // namespace fz
