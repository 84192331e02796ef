// Shared pieces of the FZ kernels for Hopper (sm_90a): stream geometry, the
// quantization codes (K1, K4), the 16x16 bit transpose by warp ballot (K2, K3,
// K5, K6), and a single-pass decoupled look-back scan across CTAs.
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

// Warp-wide bit transpose of two 16-code groups. Lane l holds code l (element
// l & 15 of group l >> 4) and gets word l & 15 (bit plane) of group l >> 4.
__device__ __forceinline__ unsigned shuffle_warp(unsigned code) {
  const int lane = threadIdx.x & 31;
  unsigned mine = 0;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const unsigned m = __brev(__ballot_sync(0xffffffffu, (code >> (15 - w)) & 1u));
    const unsigned word = lane < 16 ? (m >> 16) : (m & 0xFFFFu);
    if ((lane & 15) == w) mine = word;
  }
  return mine;
}

// The inverse: lane l holds word l & 15 of group l >> 4 and gets code l back;
// the ballot over bit k of the words gives element 15 - k of both groups.
__device__ __forceinline__ unsigned unshuffle_warp(unsigned word) {
  const int lane = threadIdx.x & 31;
  unsigned mine = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const unsigned m = __brev(__ballot_sync(0xffffffffu, (word >> k) & 1u));
    const unsigned code = lane < 16 ? (m >> 16) : (m & 0xFFFFu);
    if ((lane & 15) == 15 - k) mine = code;
  }
  return mine;
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

// Codes computed from float data (K1, K4): code(p) re-quantizes the Lorenzo
// neighbours of element p straight from the input, so no thread depends on
// another. BF16 is passed as its raw 16 bits and widened exactly. Dims: n
// elements; row = last axis; plane = last two axes. Pre-quantization is
// __fdiv_rn (a true IEEE divide) rounded half to even, as the reference; the
// delta is the inclusion-exclusion over the neighbours in unsigned 32-bit
// arithmetic, which wraps exactly as the reference's int32 differences do.
template <bool BF16, int ND>
struct CodesFromFloat {
  const void* x;
  const float* eb;                 // device scalar: the absolute error bound
  int n, row, plane;
  int zigzag;
  float two_eb;

  __device__ __forceinline__ void prepare() { two_eb = 2.0f * *eb; }

  __device__ __forceinline__ unsigned q(int p) const {
    float v;
    if (BF16) {
      v = __uint_as_float(static_cast<unsigned>(static_cast<const uint16_t*>(x)[p]) << 16);
    } else {
      v = static_cast<const float*>(x)[p];
    }
    return static_cast<unsigned>(__float2int_rn(__fdiv_rn(v, two_eb)));
  }

  __device__ __forceinline__ unsigned code(int p) const {
    if (p >= n) return 0u;                       // zero pad past the data
    unsigned d = q(p);
    if (ND == 1) {
      if (p > 0) d -= q(p - 1);
    } else if (ND == 2) {
      const int i = p / row, j = p - i * row;
      if (j > 0) d -= q(p - 1);
      if (i > 0) {
        d -= q(p - row);
        if (j > 0) d += q(p - row - 1);
      }
    } else {
      const int i = p / plane, r = p - i * plane;
      const int j = r / row, k = r - j * row;
      if (k > 0) d -= q(p - 1);
      if (j > 0) {
        d -= q(p - row);
        if (k > 0) d += q(p - row - 1);
      }
      if (i > 0) {
        d -= q(p - plane);
        if (k > 0) d += q(p - plane - 1);
        if (j > 0) {
          d += q(p - plane - row);
          if (k > 0) d -= q(p - plane - row - 1);
        }
      }
    }
    return to_code(static_cast<int>(d), zigzag);
  }
};

// Exclusive count of set flags before block b of a tile's packed flags.
__device__ __forceinline__ unsigned flags_before(const uint32_t* fw, int b) {
  unsigned c = __popc(fw[b >> 5] & ((1u << (b & 31)) - 1u));
  for (int i = 0; i < (b >> 5); ++i) c += __popc(fw[i]);
  return c;
}

}  // namespace fz
