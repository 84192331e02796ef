// K7 flash-decode for Hopper (sm_90a): split-KV online-softmax decode
// attention partials with GQA, over a paged or a contiguous KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py:
// _decode_partials_tiles (body _flash_decode_kernel). For each batch row b,
// KV head h and query head g of the GQA group it returns the online-softmax
// partials over the valid positions pos < length_eff[b]:
//   m   = max_pos s,  den = sum_pos exp(s - m),  num = sum_pos exp(s - m) v,
// with s = q . k (q pre-scaled by D^-0.5 in f32 before the launch).
//
// The TPU kernel runs a (B, T) grid with the KV-tile axis T sequential and
// keeps the (m, num, den) state in output blocks revisited across T. Hopper
// has no ordered grid, so here one CTA owns one (batch row, KV head) and
// walks that row's tiles in order itself:
//   * one warp per query head of the group (G warps; G = 8 at Yi-6B);
//   * K and V rows of the tile are staged in shared memory, CHUNK positions
//     at a time, converted to f32, and read by all G warps: the GQA reuse;
//   * lane j scores position j of the chunk (a D-long dot product against q
//     in shared memory, K rows padded by one word against bank conflicts),
//     the chunk's max and exp-sum are warp reductions, and each lane keeps
//     D/32 elements of the num accumulator in registers (lane + 32 i);
//   * m and den stay in registers; (m, num, den) are written once at the end.
// The online update is applied per chunk of up to CHUNK valid positions, which
// is the same softmax as the reference's per-tile update up to float sum
// order (the plain version is held to 2e-4).
//
// Tiles wholly past length_eff are skipped, and the last valid tile stops at
// length_eff (so the ragged tail of a contiguous slice needs no padding). This
// is exact: for an all-masked tile m_new == m_prev, corr == 1 and p == 0, so
// the reference's state is unchanged bit for bit. A row with length_eff <= 0
// keeps the empty-slice contract: m = NEG_INF (-1e30, finite), num = den = 0.
//
// Layout: K and V are (B, T, tile, KVH, D) by element strides. The batch and
// tile strides are arguments (the pool's gathered page view strides them),
// and each tile's (tile, KVH, D) block is contiguous.
//
// Bound: bytes. The valid K/V rows are read once (2 * len * KVH * D * size),
// plus q and the outputs, over 3.35 TB/s. B * KVH CTAs (16 at Yi-6B with 4
// lanes) fill few of the 132 SMs, so this first version is latency-bound;
// splitting a row's pages across CTAs with a combine pass is later work.
//
// Build without --use_fast_math. The entry point launches on the caller's
// stream and returns cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fd {

constexpr float NEG_INF = -1e30f;   // the reference's finite -inf stand-in
constexpr int CHUNK = 32;           // positions staged at a time: one per lane
constexpr int MAX_DPL = 8;          // D / 32 elements a lane, D <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (KVH, B), G * 32 threads. Dynamic shared memory: K chunk
// CHUNK x (D + 1), V chunk CHUNK x D, q G x D, all f32.
template <typename T>
__global__ void flash_decode_partials(const float* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v, const int* __restrict__ length,
                                      int T_tiles, int tile, int KVH, int G, int D,
                                      long long k_b, long long k_t, long long v_b, long long v_t,
                                      float* __restrict__ m_out, float* __restrict__ num_out,
                                      float* __restrict__ den_out) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;
  const int ks_stride = D + 1;
  float* ks = smem;                          // CHUNK x (D + 1)
  float* vs = ks + CHUNK * ks_stride;        // CHUNK x D
  float* qs = vs + CHUNK * D;                // G x D

  const long long bhg = (static_cast<long long>(b) * KVH + h) * G;
  for (int i = threadIdx.x; i < G * D; i += nthreads) qs[i] = q[bhg * D + i];

  const int len = length[b];
  const int row = KVH * D;                   // elements between two positions
  const int dpl = (D + 31) >> 5;
  float m = NEG_INF, den = 0.0f;
  float acc[MAX_DPL];
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) acc[i] = 0.0f;

  const int n_tiles = len > 0 ? min(T_tiles, (len + tile - 1) / tile) : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int valid = min(tile, len - t * tile);     // valid positions of tile t
    const T* kt = k + b * k_b + t * k_t + static_cast<long long>(h) * D;
    const T* vt = v + b * v_b + t * v_t + static_cast<long long>(h) * D;
    for (int c0 = 0; c0 < valid; c0 += CHUNK) {
      const int cnt = min(CHUNK, valid - c0);
      __syncthreads();                       // the previous chunk is consumed
      for (int i = threadIdx.x; i < cnt * D; i += nthreads) {
        const int j = i / D, d = i - j * D;
        const long long off = static_cast<long long>(c0 + j) * row + d;
        ks[j * ks_stride + d] = to_f32(kt[off]);
        vs[j * D + d] = to_f32(vt[off]);
      }
      __syncthreads();
      const float* qg = qs + warp * D;
      float s = NEG_INF;
      if (lane < cnt) {
        const float* kr = ks + lane * ks_stride;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
        s = dot;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float p = lane < cnt ? expf(s - m_new) : 0.0f;     // masked p is 0
      const float corr = expf(m - m_new);                      // 1 while both NEG_INF
      den = den * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) acc[i] *= corr;
      for (int j = 0; j < cnt; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = vs + j * D;
#pragma unroll
        for (int i = 0; i < MAX_DPL; ++i) {
          const int d = lane + 32 * i;
          if (i < dpl && d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
        }
      }
      m = m_new;
    }
  }
  const long long o = bhg + warp;            // one warp per query head
  if (lane == 0) {
    m_out[o] = m;
    den_out[o] = den;
  }
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) {
    const int d = lane + 32 * i;
    if (i < dpl && d < D) num_out[o * D + d] = acc[i];
  }
}

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* length, int B, int KVH,
           int G, int D, int T_tiles, int tile, long long k_b, long long k_t, long long v_b,
           long long v_t, float* m, float* num, float* den, cudaStream_t s) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(CHUNK) * (D + 1) +
                                       static_cast<size_t>(CHUNK) * D +
                                       static_cast<size_t>(G) * D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_partials<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_partials<T><<<dim3(KVH, B), G * 32, smem, s>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), length, T_tiles, tile, KVH, G, D,
      k_b, k_t, v_b, v_t, m, num, den);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fd

extern "C" {

const char* fz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K7. q: f32 (B, KVH, G, D) contiguous, pre-scaled by D^-0.5. k, v: f32 or
// bf16 (is_bf16) at element offset b * k_b + t * k_t + pos * KVH * D + h * D
// + d for pos < tile, t < T_tiles. length: i32 (B,) effective valid length
// (offset-adjusted, clamped to the slice). m, den: f32 (B, KVH, G); num: f32
// (B, KVH, G, D). Needs 1 <= G <= 32 and 1 <= D <= 256. Returns a cudaError_t.
int fz_flash_decode(const void* q, const void* k, const void* v, const void* length,
                    int is_bf16, int B, int KVH, int G, int D, int T_tiles, int tile,
                    long long k_b, long long k_t, long long v_b, long long v_t, void* m,
                    void* num, void* den, void* stream) {
  if (G < 1 || G > 32 || D < 1 || D > 32 * fd::MAX_DPL || B < 1 || KVH < 1 || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* len = static_cast<const int*>(length);
  float* mf = static_cast<float*>(m);
  float* nf = static_cast<float*>(num);
  float* df = static_cast<float*>(den);
  if (is_bf16)
    return fd::launch<__nv_bfloat16>(qf, k, v, len, B, KVH, G, D, T_tiles, tile, k_b, k_t, v_b,
                                     v_t, mf, nf, df, s);
  return fd::launch<float>(qf, k, v, len, B, KVH, G, D, T_tiles, tile, k_b, k_t, v_b, v_t, mf,
                           nf, df, s);
}

}  // extern "C"
