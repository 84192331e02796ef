// K4 fused_compress and K5 fused_shuffle_encode for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels repro/kernels/fused_compress.py:fused_compress
// (K4: float data -> quantize + Lorenzo + bitshuffle + zero-block flags +
// compaction in one launch) and :fused_shuffle_encode (K5: the same on given
// u16 codes, the strict-mode route). Output: packed flags u32[16 * tiles],
// payload u16[capacity, 8] (zeroed by the caller), nnz i32.
//
// Design. One CTA per 4096-code tile of the flat code stream, tiles handed out
// in ticket order. The TPU kernel walks the stream sequentially and carries a
// code remainder and the payload offset across grid steps; CTAs on the card
// run in no order, so here
//   * each thread re-quantizes the Lorenzo neighbours of its code straight
//     from the input (the cuSZ halo approach): no carry between tiles;
//   * the payload offset of a tile is the exclusive prefix of the tiles'
//     non-zero block counts, from a single-pass decoupled look-back scan.
// Bound: bytes. The input is read once (plus the neighbours, mostly from L2),
// the flags and the used payload written once; the integer work per code is a
// few dozen operations, far below the card's rate.
//
// Exactness: the codes come from fz_common.cuh's CodesFromFloat (a true IEEE
// divide, round half to even, wrapping integer deltas), shared with K1. Build
// without --use_fast_math.
#include "fz_common.cuh"

namespace fz {

// Codes given as u16 (K5); the stream is a whole number of tiles.
struct CodesU16 {
  const uint16_t* codes;
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ unsigned code(int p) const { return codes[p]; }
};

template <typename Src>
__global__ void __launch_bounds__(THREADS)
encode_tiles(Src src, uint32_t* __restrict__ bitflags, uint16_t* __restrict__ payload,
             long long capacity, int* __restrict__ nnz, unsigned long long* st,
             unsigned* ticket, int n_tiles) {
  __shared__ __align__(16) uint16_t sh[TILE];        // shuffled tile, plane-major
  __shared__ uint32_t fw[FLAG_WORDS_PER_TILE];
  src.prepare();
  const int t = static_cast<int>(take_ticket(ticket));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // quantize + bitshuffle: a warp takes 32 codes (two groups) at a time
  for (int c = warp; c < TILE / 32; c += WARPS) {
    const unsigned word = shuffle_warp(src.code(t * TILE + c * 32 + lane));
    sh[(lane & 15) * GROUPS_PER_TILE + 2 * c + (lane >> 4)] = static_cast<uint16_t>(word);
  }
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
  const unsigned base = scan_segment(st, t, 0, agg);
  if (threadIdx.x == 0 && t == n_tiles - 1) *nnz = static_cast<int>(base + agg);
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
int launch(const Src& src, int n_tiles, uint32_t* bitflags, uint16_t* payload,
           long long capacity, int* nnz, unsigned long long* scratch, cudaStream_t stream) {
  // scratch: n_tiles look-back words, then the ticket; zeroed by the caller
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + n_tiles);
  encode_tiles<Src><<<n_tiles, THREADS, 0, stream>>>(src, bitflags, payload, capacity,
                                                     nnz, scratch, ticket, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fz

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
  const int n = static_cast<int>(d0 * d1 * d2);
  const int n_tiles = (n + fz::TILE - 1) / fz::TILE;
  const int row = static_cast<int>(ndim == 3 ? d2 : d1);
  const int plane = static_cast<int>(d1 * d2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FZ_K4(BF, ND)                                                                 \
  return fz::launch(fz::CodesFromFloat<BF, ND>{x, eb, n, row, plane, zigzag, 0.0f},   \
                    n_tiles, bitflags, payload, capacity, nnz, scratch, s)
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

// K5. codes: u16[n_tiles * 4096]. Returns a cudaError_t.
int fz_fused_shuffle_encode(const uint16_t* codes, long long n_tiles, uint32_t* bitflags,
                            uint16_t* payload, long long capacity, int* nnz,
                            unsigned long long* scratch, void* stream) {
  return fz::launch(fz::CodesU16{codes}, static_cast<int>(n_tiles), bitflags, payload,
                    capacity, nnz, scratch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
