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
// Bound: bytes. The valid K/V rows are read once, 2 * len * KVH * D * size,
// plus q and the outputs. The arithmetic is 4 * len * H * D FLOPs, about
// 8 FLOP per byte at G = 8 in bf16: under the float32 CUDA-core ridge of
// 67 TFLOP/s / 3.35 TB/s = 20, so the FMAs stay on CUDA cores in float32 (the
// reference casts K/V to float32 too) and the design is about keeping bytes
// in flight on every SM.
//
// Design.
//   * Split-KV over tiles (pages). The grid is (splits, KVH, B); split s of a
//     row owns tiles [s * tps, (s + 1) * tps). The wrapper picks the split
//     count so that the grid has about two CTAs per SM: at the Yi-6B page set
//     (B 4, KVH 4, 13 pages of 64) that is one page per split, 13 x 4 x 4 =
//     208 CTAs on 132 SMs (one split per row would be 16). Each split writes
//     float32 partials (m, num, den) to scratch, and a second small launch,
//     flash_decode_combine (one CTA a query head, weights in shared memory),
//     merges them: m = max m_s, num = sum num_s exp(m_s - m), den likewise.
//     With one split the partials go straight to the outputs and the combine
//     is not launched.
//   * Wide asynchronous loads. A position's head row is D contiguous elements
//     (256 bytes at D 128 bf16), KVH * D apart. K and V rows are copied with
//     16-byte cp.async into a 2-stage ring of CHUNK positions in shared
//     memory, in their own type (bf16 or f32, not converted), so chunk i + 1
//     is in flight while chunk i is scored. Rows whose size or alignment is
//     not a multiple of 16 bytes are copied by plain loads into the same
//     layout (no such shape is on the serving path).
//   * Scores spread over lanes. 256 threads = 32 groups of 8 lanes; group
//     (g, r) serves query head g and the chunk positions j = r (mod R), R =
//     32 / G groups a head. Lane l of a group holds the 16-byte vectors l,
//     l + 8, ... of a row (8 lanes read 128 contiguous bytes: no bank
//     conflicts), its slice of q in registers, and the same slice of the num
//     accumulator. A score is 8 partial dots and 3 shuffles; the online update
//     runs per batch of SB positions. At the end the R groups of a head merge
//     through shared memory.
// The softmax is the reference's up to float32 sum order (held at 2e-4).
//
// Exactness of empty work. Tiles past length_eff are not read and the last
// valid tile stops at length_eff. A split or a row with no valid position
// keeps m = NEG_INF (-1e30, finite), num = den = 0; the combine then gives
// exp(m_s - m) = 1 and sums of zeros, so an all-empty row is (-1e30, 0, 0)
// bit for bit, and an empty split weighs exp(-1e30 - m) = 0 beside a real one.
//
// Layout: K and V are (B, T, tile, KVH, D) by element strides. The batch and
// tile strides are arguments (the pool's gathered page view strides them),
// and each tile's (tile, KVH, D) block is contiguous.
//
// Build without --use_fast_math. The entry point launches on the caller's
// stream and returns cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fd {

constexpr float NEG_INF = -1e30f;   // the reference's finite -inf stand-in
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / 8; // groups of 8 lanes
constexpr int SB = 8;               // positions a group scores per online update
constexpr int MAX_D = 256;
constexpr int STAGE_BYTES = 16384;  // K (or V) bytes a stage holds at most

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;       // elements in 16 bytes
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);          // exact bf16 -> f32
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Geometry {
  int T_tiles, tile, KVH, G, D;
  int tps;             // tiles per split
  int nv;              // 16-byte vectors per staged row (row padded to 16 bytes)
  int chunk;           // positions a stage holds
  long long k_b, k_t, v_b, v_t;
};

// Grid (splits, KVH, B), THREADS threads. Dynamic shared memory: 2 stages of
// K and V, chunk x nv x 16 bytes each; reused for the groups' merge. DMAX
// (128 or 256) sizes the lanes' register slices of q and num.
template <typename T, bool VEC16, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_decode_partials(const float* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ length, Geometry g,
                      float* __restrict__ m_out, float* __restrict__ num_out,
                      float* __restrict__ den_out) {
  constexpr int VE = Vec<T>::N;
  constexpr int MAXV = DMAX / VE / 8;       // vectors a lane holds at most
  constexpr int MAXE = MAXV * VE;           // elements a lane holds at most
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int B = gridDim.z, splits = gridDim.x;
  const int tid = threadIdx.x, grp = tid >> 3, sub = tid & 7;
  const unsigned gmask = 0xFFu << (threadIdx.x & 24);
  const int G = g.G, D = g.D;
  const int R = GROUPS / G;                 // groups a query head
  const int head = grp / R, r = grp - head * R;
  const bool active = head < G;
  const int row_bytes = g.nv * 16;
  const int stage_bytes = g.chunk * row_bytes;
  const int nvl = g.nv > sub ? (g.nv - sub + 7) >> 3 : 0;   // this lane's vectors

  // q slice in registers (zero past D), in the lane's vector layout
  const long long bhg = (static_cast<long long>(b) * g.KVH + h) * G;
  float qr[MAXE], acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXV; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = (sub + 8 * i) * VE + e;
      qr[i * VE + e] = (active && i < nvl && d < D) ? q[(bhg + head) * D + d] : 0.0f;
      acc[i * VE + e] = 0.0f;
    }
  float m = NEG_INF, den = 0.0f;

  // this split's chunks: whole tiles, the last valid tile cut at the length
  const int len = length[b];
  const int t0 = split * g.tps;
  const int t_end = min(g.T_tiles, min(t0 + g.tps, len > 0 ? (len + g.tile - 1) / g.tile : 0));
  const int cpt = (g.tile + g.chunk - 1) / g.chunk;         // chunks a tile
  int n_chunks = 0;
  if (t_end > t0) {
    const int last_valid = min(g.tile, len - (t_end - 1) * g.tile);
    n_chunks = (t_end - 1 - t0) * cpt + (last_valid + g.chunk - 1) / g.chunk;
  }
  const int row = g.KVH * D;                 // elements between two positions

  auto chunk_at = [&](int ci, int& t, int& c0, int& cnt) {
    t = t0 + ci / cpt;
    c0 = (ci - (t - t0) * cpt) * g.chunk;
    cnt = min(g.chunk, min(g.tile, len - t * g.tile) - c0);
  };
  auto load_chunk = [&](int ci) {
    int t, c0, cnt;
    chunk_at(ci, t, c0, cnt);
    unsigned char* ks = smem + (ci & 1) * 2 * stage_bytes;
    unsigned char* vs = ks + stage_bytes;
    const T* kt = k + b * g.k_b + t * g.k_t + static_cast<long long>(h) * D;
    const T* vt = v + b * g.v_b + t * g.v_t + static_cast<long long>(h) * D;
    if (VEC16) {
      for (int i = tid; i < cnt * g.nv; i += THREADS) {
        const int j = i / g.nv, c = i - j * g.nv;
        const long long off = static_cast<long long>(c0 + j) * row + c * VE;
        cp_async16(ks + j * row_bytes + c * 16, kt + off);
        cp_async16(vs + j * row_bytes + c * 16, vt + off);
      }
    } else {
      const int re = g.nv * VE;              // padded row, elements
      for (int i = tid; i < cnt * re; i += THREADS) {
        const int j = i / re, d = i - j * re;
        const long long off = static_cast<long long>(c0 + j) * row + d;
        reinterpret_cast<T*>(ks)[j * re + d] = d < D ? kt[off] : T(0.0f);
        reinterpret_cast<T*>(vs)[j * re + d] = d < D ? vt[off] : T(0.0f);
      }
    }
    cp_async_commit();
  };

  if (n_chunks > 0) load_chunk(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      load_chunk(ci + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int t, c0, cnt;
    chunk_at(ci, t, c0, cnt);
    const unsigned char* ks = smem + (ci & 1) * 2 * stage_bytes;
    const unsigned char* vs = ks + stage_bytes;
    if (active) {
      for (int j0 = r; j0 < cnt; j0 += R * SB) {
        float s[SB];
        float smax = NEG_INF;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          const int j = j0 + i * R;
          float part = 0.0f;
          if (j < cnt) {
            const uint4* kr = reinterpret_cast<const uint4*>(ks + j * row_bytes);
#pragma unroll
            for (int c = 0; c < MAXV; ++c) {
              if (c < nvl) {
                float f[VE];
                Vec<T>::load(kr[sub + 8 * c], f);
#pragma unroll
                for (int e = 0; e < VE; ++e) part = fmaf(qr[c * VE + e], f[e], part);
              }
            }
          }
          part += __shfl_xor_sync(gmask, part, 1);
          part += __shfl_xor_sync(gmask, part, 2);
          part += __shfl_xor_sync(gmask, part, 4);
          s[i] = j < cnt ? part : NEG_INF;
          smax = fmaxf(smax, s[i]);
        }
        const float m_new = fmaxf(m, smax);
        const float corr = expf(m - m_new);               // 1 while both NEG_INF
        float psum = 0.0f;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          s[i] = j0 + i * R < cnt ? expf(s[i] - m_new) : 0.0f;   // masked p is 0
          psum += s[i];
        }
        den = den * corr + psum;
#pragma unroll
        for (int e = 0; e < MAXE; ++e) acc[e] *= corr;
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          const int j = j0 + i * R;
          if (j < cnt) {
            const uint4* vr = reinterpret_cast<const uint4*>(vs + j * row_bytes);
#pragma unroll
            for (int c = 0; c < MAXV; ++c) {
              if (c < nvl) {
                float f[VE];
                Vec<T>::load(vr[sub + 8 * c], f);
#pragma unroll
                for (int e = 0; e < VE; ++e) acc[c * VE + e] = fmaf(s[i], f[e], acc[c * VE + e]);
              }
            }
          }
        }
        m = m_new;
      }
    }
    __syncthreads();                          // the stage is consumed before its reuse
  }

  // merge the R groups of each query head through shared memory
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_den = red_m + GROUPS;
  float* red_acc = red_den + GROUPS;          // GROUPS x (nv * VE)
  const int dp = g.nv * VE;
  if (active) {
    if (sub == 0) {
      red_m[grp] = m;
      red_den[grp] = den;
    }
#pragma unroll
    for (int c = 0; c < MAXV; ++c)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        if (c < nvl) red_acc[grp * dp + (sub + 8 * c) * VE + e] = acc[c * VE + e];
  }
  __syncthreads();
  const long long o = splits > 1 ? static_cast<long long>(split) * B * g.KVH * G + bhg : bhg;
  for (int i = tid; i < G * D; i += THREADS) {
    const int hg = i / D, d = i - hg * D;
    float mm = NEG_INF;
    for (int rr = 0; rr < R; ++rr) mm = fmaxf(mm, red_m[hg * R + rr]);
    float nsum = 0.0f, dsum = 0.0f;
    for (int rr = 0; rr < R; ++rr) {
      const float w = expf(red_m[hg * R + rr] - mm);
      nsum = fmaf(red_acc[(hg * R + rr) * dp + d], w, nsum);
      dsum = fmaf(red_den[hg * R + rr], w, dsum);
    }
    num_out[(o + hg) * D + d] = nsum;
    if (d == 0) {
      m_out[o + hg] = mm;
      den_out[o + hg] = dsum;
    }
  }
}

// Merge the splits' partials: grid (G, KVH, B), COMBINE_THREADS threads, one
// CTA a query head. Warp 0 takes the max over the splits and their weights
// exp(m_s - m) into shared memory (splits floats, dynamic); then every thread
// sums its elements of num over the splits with independent loads. pm/pden:
// (splits, B, KVH, G); pnum: (splits, B, KVH, G, D).
constexpr int COMBINE_THREADS = 128;
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine(const float* __restrict__ pm, const float* __restrict__ pnum,
                     const float* __restrict__ pden, int splits, int KVH, int D,
                     float* __restrict__ m_out, float* __restrict__ num_out,
                     float* __restrict__ den_out) {
  extern __shared__ float w[];
  const int G = gridDim.x;
  const long long o = (static_cast<long long>(blockIdx.z) * KVH + blockIdx.y) * G + blockIdx.x;
  const long long stride = static_cast<long long>(gridDim.z) * KVH * G;   // one split
  if (threadIdx.x < 32) {
    float mm = NEG_INF;
    for (int s = threadIdx.x; s < splits; s += 32) mm = fmaxf(mm, pm[s * stride + o]);
    mm = warp_max(mm);
    float dsum = 0.0f;
    for (int s = threadIdx.x; s < splits; s += 32) {
      const float ws = expf(pm[s * stride + o] - mm);   // 1 for every split of an empty row
      w[s] = ws;
      dsum = fmaf(pden[s * stride + o], ws, dsum);
    }
    dsum = warp_sum(dsum);
    if (threadIdx.x == 0) {
      m_out[o] = mm;
      den_out[o] = dsum;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += COMBINE_THREADS) {
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) acc = fmaf(pnum[(s * stride + o) * D + d], w[s], acc);
    num_out[o * D + d] = acc;
  }
}

// Positions a stage holds for rows of nv 16-byte vectors.
inline int stage_chunk(int nv) {
  return STAGE_BYTES / (nv * 16) < 32 ? STAGE_BYTES / (nv * 16) : 32;
}

// Dynamic shared bytes of the partials: two stages of K and V, or the
// groups' merge where that is larger (ve: elements a 16-byte vector).
inline size_t partials_smem(int chunk, int nv, int ve) {
  const size_t stages = 4ull * chunk * nv * 16;
  const size_t merge = sizeof(float) * (2ull * GROUPS + static_cast<size_t>(GROUPS) * nv * ve);
  return stages > merge ? stages : merge;
}

template <typename T, bool VEC16, int DMAX>
int launch_partials(const float* q, const void* k, const void* v, const int* length, int B,
                    int splits, const Geometry& g, float* m, float* num, float* den,
                    cudaStream_t s) {
  const size_t smem = partials_smem(g.chunk, g.nv, Vec<T>::N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_decode_partials<T, VEC16, DMAX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_partials<T, VEC16, DMAX><<<dim3(splits, g.KVH, B), THREADS, smem, s>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v), length, g, m, num, den);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const float* q, const void* k, const void* v, const int* length, int B, int KVH,
           int G, int D, int T_tiles, int tile, int splits, long long k_b, long long k_t,
           long long v_b, long long v_t, float* m, float* num, float* den, float* scratch,
           cudaStream_t s) {
  constexpr int VE = Vec<T>::N;
  Geometry g;
  g.T_tiles = T_tiles; g.tile = tile; g.KVH = KVH; g.G = G; g.D = D;
  g.tps = (T_tiles + splits - 1) / splits;
  g.nv = (D + VE - 1) / VE;
  g.chunk = stage_chunk(g.nv);
  g.k_b = k_b; g.k_t = k_t; g.v_b = v_b; g.v_t = v_t;
  // 16-byte copies need 16-byte rows, strides and bases
  const long long align = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) |
      ((static_cast<unsigned long long>(D) | static_cast<unsigned long long>(KVH) * D |
        k_b | k_t | v_b | v_t) * sizeof(T));
  const bool vec16 = (align & 15) == 0;
  float *pm = m, *pnum = num, *pden = den;
  if (splits > 1) {
    const long long bhg = static_cast<long long>(B) * KVH * G;
    pm = scratch;
    pden = pm + splits * bhg;
    pnum = pden + splits * bhg;
  }
  int rc;
  if (D <= 128)
    rc = vec16 ? launch_partials<T, true, 128>(q, k, v, length, B, splits, g, pm, pnum, pden, s)
               : launch_partials<T, false, 128>(q, k, v, length, B, splits, g, pm, pnum, pden, s);
  else
    rc = vec16 ? launch_partials<T, true, MAX_D>(q, k, v, length, B, splits, g, pm, pnum, pden, s)
               : launch_partials<T, false, MAX_D>(q, k, v, length, B, splits, g, pm, pnum, pden,
                                                  s);
  if (rc != 0 || splits == 1) return rc;
  flash_decode_combine<<<dim3(G, KVH, B), COMBINE_THREADS, sizeof(float) * splits, s>>>(
      pm, pnum, pden, splits, KVH, D, m, num, den);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fd

extern "C" {

const char* fz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Float32 words of the split scratch the caller allocates when splits > 1:
// (m, den, num) of every split.
long long fz_flash_decode_scratch_floats(int B, int KVH, int G, int D, int splits) {
  return splits > 1 ? static_cast<long long>(splits) * B * KVH * G * (D + 2) : 0;
}

// Dynamic shared bytes that fz_flash_decode sets for its partials at head
// size D, and for the combine of `splits` splits.
long long fz_flash_decode_smem(int is_bf16, int D) {
  const int ve = is_bf16 ? 8 : 4, nv = (D + ve - 1) / ve;
  return static_cast<long long>(fd::partials_smem(fd::stage_chunk(nv), nv, ve));
}

long long fz_flash_decode_combine_smem(int splits) {
  return static_cast<long long>(sizeof(float) * splits);
}

// K7. q: f32 (B, KVH, G, D) contiguous, pre-scaled by D^-0.5. k, v: f32 or
// bf16 (is_bf16) at element offset b * k_b + t * k_t + pos * KVH * D + h * D
// + d for pos < tile, t < T_tiles. length: i32 (B,) effective valid length
// (offset-adjusted, clamped to the slice). splits: 1 <= splits <= T_tiles, 8192,
// each split owning ceil(T_tiles / splits) tiles. m, den: f32 (B, KVH, G);
// num: f32 (B, KVH, G, D). scratch: fz_flash_decode_scratch_floats floats.
// Needs 1 <= G <= 32 and 1 <= D <= 256. Returns a cudaError_t.
int fz_flash_decode(const void* q, const void* k, const void* v, const void* length,
                    int is_bf16, int B, int KVH, int G, int D, int T_tiles, int tile,
                    int splits, long long k_b, long long k_t, long long v_b, long long v_t,
                    void* m, void* num, void* den, void* scratch, void* stream) {
  if (G < 1 || G > 32 || D < 1 || D > fd::MAX_D || B < 1 || KVH < 1 || tile < 1 ||
      T_tiles < 1 || splits < 1 || splits > T_tiles || splits > 8192 ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* len = static_cast<const int*>(length);
  float* mf = static_cast<float*>(m);
  float* nf = static_cast<float*>(num);
  float* df = static_cast<float*>(den);
  float* sf = static_cast<float*>(scratch);
  if (is_bf16)
    return fd::launch<__nv_bfloat16>(qf, k, v, len, B, KVH, G, D, T_tiles, tile, splits, k_b,
                                     k_t, v_b, v_t, mf, nf, df, sf, s);
  return fd::launch<float>(qf, k, v, len, B, KVH, G, D, T_tiles, tile, splits, k_b, k_t, v_b,
                           v_t, mf, nf, df, sf, s);
}

}  // extern "C"
