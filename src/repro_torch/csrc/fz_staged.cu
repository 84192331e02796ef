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
// is not part of the function. Here one thread computes one code: it
// re-quantizes its Lorenzo neighbours from the input (fz_common.cuh's
// CodesFromFloat, with the same quantize as K4, which pre-quantizes a tile's
// neighbourhood once in shared memory instead; chip_smoke.py holds both
// against their plain versions). Bound: bytes (4n or 2n read, 2n written);
// the neighbour reads mostly hit L1/L2, and the up to 8 IEEE divides a code
// are the instruction cost that keeps it off that bound.
//
// K2 replaces repro/kernels/bitshuffle_flag.py:bitshuffle_flag (u16 tiles ->
// plane-major bitshuffled tiles + one u8 nonzero flag per 8-word block), K3
// replaces :bitunshuffle_tiles (the inverse shuffle). The TPU kernels do the
// 16x16 bit transpose as a 4-stage masked swap on vector lanes. Both keep the
// reference's (e, b) -> (15-b, 15-e) convention, one CTA per 4096-code tile,
// and are bound by bytes (K2: 2n read, 2n + n/8 written; K3: 2n read, 2n
// written).
//   * K2: the tile is read into shared memory with 16-byte loads, transposed
//     by warp ballot (fz_common.cuh's shuffle_warp) between two shared
//     buffers, and written back with 16-byte stores. The plane-major buffer
//     is padded by 8 words a plane so that the 16 planes a warp touches fall
//     in 8 banks, not 1.
//   * K3: the tile's shuffled words are read into shared memory with 16-byte
//     loads (plane-major as stored: no padding needed, since thread g reads
//     word g of each plane), thread g transposes its group in registers
//     (unshuffle_group, as K6) and writes its 16 codes with two 16-byte
//     stores, so a warp writes 1 KB contiguous. No second buffer, no ballot.
//
// Build without --use_fast_math. Every entry point launches on the caller's
// stream and returns cudaGetLastError().
#include "fz_common.cuh"

namespace fz {

constexpr int PLANES = 16;                          // bit planes (words) of a group
constexpr int PLANE_STRIDE = GROUPS_PER_TILE + 8;   // padded plane of the shared tile

template <bool BF16, int ND>
__global__ void __launch_bounds__(THREADS)
lorenzo_quant_codes(CodesFromFloat<BF16, ND> src, uint16_t* __restrict__ codes) {
  src.prepare();
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p < src.n) codes[p] = static_cast<uint16_t>(src.code(p));
}

__global__ void __launch_bounds__(THREADS)
bitshuffle_flag_tiles(const uint16_t* __restrict__ codes, uint16_t* __restrict__ shuffled,
                      uint8_t* __restrict__ flags) {
  __shared__ __align__(16) uint16_t in[TILE];                   // codes, in order
  __shared__ __align__(16) uint16_t sh[PLANES * PLANE_STRIDE];  // plane-major
  const long long t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* src = reinterpret_cast<const uint4*>(codes + t * TILE);
  for (int i = threadIdx.x; i < TILE / 8; i += THREADS) reinterpret_cast<uint4*>(in)[i] = src[i];
  __syncthreads();

  for (int c = warp; c < TILE / 32; c += WARPS) {
    const unsigned word = shuffle_warp(in[c * 32 + lane]);
    sh[(lane & 15) * PLANE_STRIDE + 2 * c + (lane >> 4)] = static_cast<uint16_t>(word);
  }
  __syncthreads();

  // block b holds words 8(b & 31) .. +8 of plane b >> 5
  uint4* dst = reinterpret_cast<uint4*>(shuffled + t * TILE);
  for (int b = threadIdx.x; b < BLOCKS_PER_TILE; b += THREADS) {
    const uint4 v = *reinterpret_cast<const uint4*>(sh + (b >> 5) * PLANE_STRIDE + (b & 31) * 8);
    dst[b] = v;
    flags[t * BLOCKS_PER_TILE + b] = (v.x | v.y | v.z | v.w) != 0u;
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
  uint4* dst = reinterpret_cast<uint4*>(codes + t * TILE + threadIdx.x * 16);
  dst[0] = make_uint4(c[0] | c[1] << 16, c[2] | c[3] << 16, c[4] | c[5] << 16, c[6] | c[7] << 16);
  dst[1] = make_uint4(c[8] | c[9] << 16, c[10] | c[11] << 16, c[12] | c[13] << 16,
                      c[14] | c[15] << 16);
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
  const int n = static_cast<int>(d0 * d1 * d2);
  const int row = static_cast<int>(ndim == 3 ? d2 : d1);
  const int plane = static_cast<int>(d1 * d2);
  const int blocks = (n + fz::THREADS - 1) / fz::THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FZ_K1(BF, ND)                                                                   \
  fz::lorenzo_quant_codes<BF, ND><<<blocks, fz::THREADS, 0, s>>>(                        \
      fz::CodesFromFloat<BF, ND>{x, eb, n, row, plane, zigzag, 0.0f}, codes);           \
  return static_cast<int>(cudaGetLastError())
  if (is_bf16) {
    if (ndim == 1) { FZ_K1(true, 1); }
    if (ndim == 2) { FZ_K1(true, 2); }
    FZ_K1(true, 3);
  }
  if (ndim == 1) { FZ_K1(false, 1); }
  if (ndim == 2) { FZ_K1(false, 2); }
  FZ_K1(false, 3);
#undef FZ_K1
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
