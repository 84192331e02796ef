// Shared pieces of the FZ kernels for Hopper (sm_90a): stream geometry, the
// 16x16 bit transpose by warp ballot, and a single-pass decoupled look-back
// scan across CTAs.
//
// Bit convention (the reference's, repro/core/shuffle.py): bit b of element e
// of a 16-code group lands in bit 15-e of word 15-b, and a tile's words are
// stored plane-major (word w of group g at w*256 + g). A warp holds 32
// consecutive codes (two groups); one ballot per bit plane gives both groups'
// word for that plane after a 32-bit reversal.
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

__device__ __forceinline__ void publish(unsigned long long* st, long long i,
                                        unsigned long long status, unsigned v) {
  __threadfence();
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

__device__ __forceinline__ long long take_ticket(unsigned* ticket) {
  __shared__ long long s_seg;
  if (threadIdx.x == 0) s_seg = atomicAdd(ticket, 1u);
  __syncthreads();
  return s_seg;
}

// Exclusive count of set flags before block b of a tile's packed flags.
__device__ __forceinline__ unsigned flags_before(const uint32_t* fw, int b) {
  unsigned c = __popc(fw[b >> 5] & ((1u << (b & 31)) - 1u));
  for (int i = 0; i < (b >> 5); ++i) c += __popc(fw[i]);
  return c;
}

}  // namespace fz
