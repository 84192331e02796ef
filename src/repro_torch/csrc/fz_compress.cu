// K4 fused_compress and K5 fused_shuffle_encode for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels repro/kernels/fused_compress.py:fused_compress
// (K4: float data -> quantize + Lorenzo + bitshuffle + zero-block flags +
// compaction in one launch) and :fused_shuffle_encode (K5: the same on given
// u16 codes, the strict-mode route). Output: packed flags u32[16 * tiles],
// payload u16[capacity, 8] (zeroed by the caller), nnz i32.
//
// Bound: bytes. The input is read once, the flags and the used payload
// written once; the function needs one divide per element and a few dozen
// integer operations per code, far below the card's rate.
//
// Design. One CTA per 4096-code tile of the flat code stream, tiles handed out
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
//     into the shared tile, a conflict-free store. K5 loads its group's 16
//     codes with two 16-byte loads and shares the rest;
//   * the payload offset of a tile is the exclusive prefix of the tiles'
//     non-zero block counts, from a single-pass decoupled look-back scan.
// The window buffer is padded by one word every 16 (fz_windows.cuh). The
// shuffled tile reuses the start of the buffer once every thread has made its
// codes.
//
// Exactness: the pre-quantization is fz_common.cuh's quantize (a true IEEE
// divide, round half to even, converted as XLA does), the deltas wrap in
// unsigned 32-bit arithmetic, bf16 widens by its raw bits; K1 computes the
// same codes (fz_staged.cu), and chip_smoke.py holds both against their plain
// versions. Build without --use_fast_math.
#include "fz_windows.cuh"

namespace fz {

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
  src.codes(smem, t * TILE, threadIdx.x, a);
  shuffle_group(a);
  __syncthreads();                                   // every window read is done
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
  const int rows = static_cast<int>(d1);
  const int esize = is_bf16 ? 2 : 4, vec = 16 / esize;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x) % 16) / esize;
  const fz::Windows win = fz::plan_windows(ndim == 3 ? 4 : ndim, row, plane, vec, mis);
  const int words = win.chunks * vec;
  const size_t smem = sizeof(unsigned) * (words + words / 16 + 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FZ_K4(BF, ND)                                                                    \
  return fz::launch(fz::WindowCodes<BF, ND>{x, eb, n, row, plane, rows, zigzag, win}, smem, \
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
  const int aligned = reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  return fz::launch(fz::CodesU16{codes, aligned}, fz::TILE * sizeof(uint16_t), static_cast<int>(n_tiles),
                    bitflags, payload, capacity, nnz, scratch,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
