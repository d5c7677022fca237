// Flash-decoding: one query token per sequence against a GQA KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel (Pallas,
// TPU).  q [B, H, D], k/v cache [B, S, Hkv, D] (bf16 or f32, all three of
// one type), query head h reads KV head h / (H / Hkv).  Positions
// t <= cache_len (and t < S) are attended, scores are scaled by D^-0.5 and
// the softmax runs in f32; out [B, H, D] f32 is acc / max(l, 1e-30), so a
// sequence with no valid position gets zeros, as on the TPU.
//
// What bounds it on an H100: bytes.  Every valid K and V row is read once
// (the RAG shape B=8, S=2112, Hkv=2, D=128 bf16 reads 17.3 MB, ~5.2 us at
// 3.35 TB/s); the arithmetic, 4*H*D flops per position, is far below the
// tensor cores' rate.
//
// Design (simple first; no wgmma or TMA yet): the TPU walks the KV blocks of
// one sequence in order and carries (m, l, acc) in its output block.  Here
// the sequence is cut into chunks and blocks run in parallel, one per
// (chunk, KV head, batch row), so even B=1 fills the card.  A block keeps the
// cache in its GQA layout: it stages a 32-position tile of K and V for its
// KV head in shared memory (f32), scores the tile for all G = H/Hkv query
// heads of the group (lane = position, warp = a slice of the heads), updates
// each head's running max and sum with warp shuffles, then every thread
// accumulates probs x V for its dims and all G heads in registers.  Each
// block writes its partial (m, l, acc); decode_combine_kernel rescales and
// sums the chunks of each (b, h).  Chunks wholly past cache_len do nothing
// and the combine skips them, which is the TPU kernel's guard against
// exp(-inf - -inf) in fully masked blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                     // positions per staged tile
constexpr int kMaxD = 256;
constexpr int kDimsPerThread = kMaxD / kThreads;

template <typename T>
struct Vec;                                   // 16-byte loads of T -> f32

template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// Shared memory, in floats: q [G][D] | k [kTile][D+1] | v [kTile][D] |
// p [G][kTile] | alpha [G].  The odd K row stride keeps the score pass
// (lane = row) free of bank conflicts.
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D + static_cast<size_t>(kTile) * (D + 1) +
         static_cast<size_t>(kTile) * D + static_cast<size_t>(G) * kTile + G;
}

template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ len_ptr,
                    int len_host, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int H, int Hkv, int S, int D, int chunk, float scale) {
  constexpr int kHeadsPerWarp = (GMAX + kWarps - 1) / kWarps;
  constexpr int VN = Vec<T>::n;
  extern __shared__ __align__(16) float dsmem[];
  const int G = H / Hkv;
  float* q_s = dsmem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kTile * (D + 1);
  float* p_s = v_s + kTile * D;
  float* alpha_s = p_s + G * kTile;

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int cache_len = len_ptr != nullptr ? *len_ptr : len_host;
  const int n_valid = min(S, cache_len + 1);
  const int start = c * chunk;
  const int end = min(start + chunk, n_valid);
  if (start >= end) return;                   // wholly masked: combine skips

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = Vec<T>::one(q[head0 * D + i]);

  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }
  float acc[GMAX][kDimsPerThread];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] = 0.f;

  const int vec_per_row = D / VN;
  for (int t0 = start; t0 < end; t0 += kTile) {
    const int nt = min(kTile, end - t0);
    __syncthreads();                          // previous tile fully consumed
    for (int i = tid; i < kTile * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int col = (i - r * vec_per_row) * VN;
      float kf[VN], vf[VN];
      if (r < nt) {
        const size_t off =
            ((static_cast<size_t>(b) * S + t0 + r) * Hkv + kvh) * D + col;
        Vec<T>::load(k + off, kf);
        Vec<T>::load(v + off, vf);
      } else {
#pragma unroll
        for (int u = 0; u < VN; ++u) kf[u] = vf[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        k_s[r * (D + 1) + col + u] = kf[u];
        v_s[r * D + col + u] = vf[u];
      }
    }
    __syncthreads();

    // scores of position `lane` for the warp's heads w, w+4, ...
    float s[kHeadsPerWarp];
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) s[j] = 0.f;
    const float* kr = k_s + lane * (D + 1);
    for (int d = 0; d < D; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const int g = warp + kWarps * j;
        if (g < G) {
          const float4 qq = *reinterpret_cast<const float4*>(q_s + g * D + d);
          s[j] = fmaf(qq.x, k0, s[j]);
          s[j] = fmaf(qq.y, k1, s[j]);
          s[j] = fmaf(qq.z, k2, s[j]);
          s[j] = fmaf(qq.w, k3, s[j]);
        }
      }
    }
    const bool valid = lane < nt;             // nt >= 1: lane 0 is valid
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + kWarps * j;
      if (g >= G) continue;                   // warp-uniform
      const float sc = valid ? s[j] * scale : -INFINITY;
      float mt = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run[j], mt);          // finite
      const float alpha = expf(m_run[j] - m_new);       // 0 on the first tile
      const float p = valid ? expf(sc - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run[j] = l_run[j] * alpha + ps;
      m_run[j] = m_new;
      p_s[g * kTile + lane] = p;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] v[t][d]; rows >= nt are zero
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d >= D) continue;
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g][i] *= alpha_s[g];
      for (int t = 0; t < kTile; t += 4) {
        const float v0 = v_s[t * D + d], v1 = v_s[(t + 1) * D + d];
        const float v2 = v_s[(t + 2) * D + d], v3 = v_s[(t + 3) * D + d];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(p_s + g * kTile + t);
            float a = acc[g][i];
            a = fmaf(p4.x, v0, a);
            a = fmaf(p4.y, v1, a);
            a = fmaf(p4.z, v2, a);
            a = fmaf(p4.w, v3, a);
            acc[g][i] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int g = warp + kWarps * j;
    if (g < G && lane == 0) {
      const size_t o = (head0 + g) * nc + c;
      part_m[o] = m_run[j];
      part_l[o] = l_run[j];
    }
  }
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) part_acc[((head0 + g) * nc + c) * D + d] = acc[g][i];
  }
}

// One block per (b, h): out = sum_c acc_c e^(m_c - M) / max(sum_c l_c
// e^(m_c - M), 1e-30) over the chunks that held a valid position.
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ len_ptr, int len_host,
                      float* __restrict__ out, int S, int D, int chunk,
                      int nc) {
  extern __shared__ float wsmem[];            // [nc] chunk weights
  const size_t bh = blockIdx.x;
  const int cache_len = len_ptr != nullptr ? *len_ptr : len_host;
  const int n_valid = min(S, cache_len + 1);
  const int used = n_valid > 0 ? min(nc, (n_valid + chunk - 1) / chunk) : 0;
  const float* m = part_m + bh * nc;
  const float* l = part_l + bh * nc;
  float big = -INFINITY;
  for (int c = 0; c < used; ++c) big = fmaxf(big, m[c]);
  for (int c = threadIdx.x; c < used; c += kThreads)
    wsmem[c] = expf(m[c] - big);
  __syncthreads();
  float lsum = 0.f;
  for (int c = 0; c < used; ++c) lsum += l[c] * wsmem[c];
  const float denom = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int c = 0; c < used; ++c)
      o += part_acc[(bh * nc + c) * D + d] * wsmem[c];
    out[bh * D + d] = o / denom;
  }
}

template <typename T, int GMAX>
cudaError_t launch_chunks(const void* q, const void* k, const void* v,
                          const int* len_ptr, int len_host, float* part_m,
                          float* part_l, float* part_acc, int B, int H,
                          int Hkv, int S, int D, int chunk, int nc,
                          float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(H / Hkv, D) * sizeof(float);
  auto kernel = decode_chunk_kernel<T, GMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nc, Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len_ptr, len_host, part_m, part_l, part_acc,
      H, Hkv, S, D, chunk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_by_group(int gmax, const void* q, const void* k,
                            const void* v, const int* len_ptr, int len_host,
                            float* part_m, float* part_l, float* part_acc,
                            int B, int H, int Hkv, int S, int D, int chunk,
                            int nc, float scale, cudaStream_t stream) {
#define HAS_DECODE_CASE(G_)                                                  \
  case G_:                                                                   \
    return launch_chunks<T, G_>(q, k, v, len_ptr, len_host, part_m, part_l, \
                                part_acc, B, H, Hkv, S, D, chunk, nc, scale, \
                                stream);
  switch (gmax) {
    HAS_DECODE_CASE(1)
    HAS_DECODE_CASE(2)
    HAS_DECODE_CASE(4)
    HAS_DECODE_CASE(8)
    HAS_DECODE_CASE(16)
    HAS_DECODE_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef HAS_DECODE_CASE
}

}  // namespace

extern "C" {

// q [B,H,D], k/v [B,S,Hkv,D] (bf16 if is_bf16, else f32); len_ptr (device
// int32, may be null) or len_host is the cache length; part_m/part_l
// [B,H,nc], part_acc [B,H,nc,D] scratch; out [B,H,D] f32.  gmax is the
// smallest of 1,2,4,...,32 >= H/Hkv; D % 8 == 0 (bf16) or D % 4 == 0 (f32),
// D <= 256; chunk is a multiple of 32 and nc = ceil(covered / chunk);
// scale is D^-0.5 rounded once to f32, as the reference multiplies.
int has_decode_attention(const void* q, const void* k, const void* v,
                         const int* len_ptr, int len_host, float* part_m,
                         float* part_l, float* part_acc, float* out, int B,
                         int H, int Hkv, int S, int D, int chunk, int nc,
                         float scale, int gmax, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_by_group<__nv_bfloat16>(
                    gmax, q, k, v, len_ptr, len_host, part_m, part_l,
                    part_acc, B, H, Hkv, S, D, chunk, nc, scale, st)
              : launch_by_group<float>(gmax, q, k, v, len_ptr, len_host,
                                       part_m, part_l, part_acc, B, H, Hkv,
                                       S, D, chunk, nc, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<<<B * H, kThreads, nc * sizeof(float), st>>>(
      part_m, part_l, part_acc, len_ptr, len_host, out, S, D, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
