// IVF probed-bucket scan: f32 buckets (the HaS fuzzy channel) and int8
// centroid-residual codes (the compressed ANN cloud stage).
//
// Replaces src/repro/kernels/ivf_scan.py::_ivf_kernel and its scaled mode
// _ivf_kernel_scaled (Pallas, TPU): per (query b, probe p) the [cap,d]
// bucket probe[b,p] is scored against q[b], pad slots (id < 0) are masked,
// and the global ids fold into a running top-k.  On the TPU the probe
// table is scalar-prefetched so the BlockSpec can DMA the chosen bucket;
// here each block reads its own probe[b,p].
//
// What bounds it on an H100: bytes.  Each probed bucket is read once per
// query.  f32: B*P*cap*d*4 bytes, about 24 MB at the fuzzy channel's shape
// (B=1, P=64, cap=123, d=768), about 7 us at 3.35 TB/s.  int8: B*P*cap*
// (d + 8 + 4) bytes (codes, two scales, the id), about 24.4 MB at the
// cloud stage's shape (B=1, P=32, cap=977, d=768), about 7.3 us.
//
// Design: grid (P * S, B): each probed bucket is cut into S row ranges
// (the wrapper picks S so that a batch of one still puts a few blocks on
// every SM), one block each; 256 threads, one warp per bucket row.  Lanes
// read 16 bytes (f32: float4) or 4 bytes (int8: char4) at a time, four
// (f32) or eight (int8) loads in flight before their FMAs, when d % 4
// (f32) or d % 8 (int8) is 0 and the rows are aligned; otherwise one
// element at a time.  Scores land
// in shared memory and warp 0 selects the range's top-k with tie key
// p*cap + slot (the flat position the reference's lax.top_k breaks ties
// on).  The int8 kernel keeps one sum per half and scores (dot_lo*s_lo +
// dot_hi*s_hi) + bias[b,p] with rounded, uncontracted multiplies and adds,
// in the reference's order.  Pass 2 is topk_merge_kernel over [B, P*S*k],
// the same merge as topk_search.
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// vector loads in flight per lane: f32 rows of 768 take 6 float4 a lane,
// int8 rows 6 char4 (all of a row's codes at once)
constexpr int kUnrollF32 = 4;
constexpr int kUnrollInt8 = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The rows [r0, r1) of range z of S over a bucket of cap rows.
__device__ __forceinline__ void row_range(int cap, int S, int z, int* r0,
                                          int* r1) {
  const int per = (cap + S - 1) / S;
  *r0 = min(cap, z * per);
  *r1 = min(cap, *r0 + per);
}

// Warp 0 writes the range's top-k candidates (score, p*cap+slot, id).
__device__ __forceinline__ void emit_range_topk(
    float* sc, const int* ids, int r0, int n, size_t base, int p, int cap,
    int k, int lane, float* cand_vals, int* cand_keys, int* cand_ids) {
  has_kernels::warp_topk(sc, nullptr, n, k, lane,
                         [&](int j, float v, int pos) {
                           cand_vals[base + j] = v;
                           cand_keys[base + j] =
                               pos < 0 ? -1 : p * cap + r0 + pos;
                           cand_ids[base + j] = pos < 0 ? -1 : ids[r0 + pos];
                         });
}

// One warp's q . v for a row of d floats (q in shared memory).
template <bool kVec>
__device__ __forceinline__ float row_dot_f32(const float* __restrict__ v,
                                             const float* qs, int d,
                                             int lane) {
  float acc = 0.f;
  if (kVec) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const int n4 = d / 4;
    for (int e0 = lane; e0 < n4; e0 += 32 * kUnrollF32) {
      float4 x[kUnrollF32];
#pragma unroll
      for (int u = 0; u < kUnrollF32; ++u) {
        const int e = e0 + 32 * u;
        x[u] = e < n4 ? v4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnrollF32; ++u) {
        const int e = e0 + 32 * u;
        if (e < n4) {
          const float4 y = q4[e];
          acc = fmaf(y.x, x[u].x, acc);
          acc = fmaf(y.y, x[u].y, acc);
          acc = fmaf(y.z, x[u].z, acc);
          acc = fmaf(y.w, x[u].w, acc);
        }
      }
    }
  } else {
    for (int e = lane; e < d; e += 32) acc = fmaf(qs[e], v[e], acc);
  }
  return warp_sum(acc);
}

// One warp's (q_lo . v_lo, q_hi . v_hi) for a row of d int8 codes.
template <bool kVec>
__device__ __forceinline__ float2 row_dot_int8(
    const signed char* __restrict__ v, const float* qs, int d, int lane) {
  const int h = d / 2;
  float lo = 0.f, hi = 0.f;
  if (kVec) {
    const char4* v4 = reinterpret_cast<const char4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const int n4 = d / 4;
    const int h4 = h / 4;
    for (int e0 = lane; e0 < n4; e0 += 32 * kUnrollInt8) {
      char4 x[kUnrollInt8];
#pragma unroll
      for (int u = 0; u < kUnrollInt8; ++u) {
        const int e = e0 + 32 * u;
        x[u] = e < n4 ? v4[e] : make_char4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnrollInt8; ++u) {
        const int e = e0 + 32 * u;
        if (e < n4) {
          const float4 y = q4[e];
          float t = e < h4 ? lo : hi;
          t = fmaf(y.x, static_cast<float>(x[u].x), t);
          t = fmaf(y.y, static_cast<float>(x[u].y), t);
          t = fmaf(y.z, static_cast<float>(x[u].z), t);
          t = fmaf(y.w, static_cast<float>(x[u].w), t);
          if (e < h4) lo = t; else hi = t;
        }
      }
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float x = static_cast<float>(v[e]);
      if (e < h) lo = fmaf(qs[e], x, lo); else hi = fmaf(qs[e], x, hi);
    }
  }
  return make_float2(warp_sum(lo), warp_sum(hi));
}

template <bool kVec>
__global__ void ivf_bucket_kernel(const float* __restrict__ q,
                                  const int* __restrict__ probe,
                                  const float* __restrict__ bucket_vecs,
                                  const int* __restrict__ bucket_ids,
                                  float* __restrict__ cand_vals,
                                  int* __restrict__ cand_keys,
                                  int* __restrict__ cand_ids, int P, int C,
                                  int cap, int d, int k, int S) {
  extern __shared__ float smem[];
  float* qs = smem;        // [d]
  float* sc = smem + d;    // [rows of the range]
  const int p = blockIdx.x / S;
  const int z = blockIdx.x % S;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // an out-of-range probe is clamped, as the reference's gather clamps
  const int c = min(max(probe[static_cast<size_t>(b) * P + p], 0), C - 1);
  const float* vecs = bucket_vecs + static_cast<size_t>(c) * cap * d;
  const int* ids = bucket_ids + static_cast<size_t>(c) * cap;
  int r0, r1;
  row_range(cap, S, z, &r0, &r1);

  for (int i = threadIdx.x; i < d; i += kThreads)
    qs[i] = q[static_cast<size_t>(b) * d + i];
  __syncthreads();

  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float acc =
        row_dot_f32<kVec>(vecs + static_cast<size_t>(r) * d, qs, d, lane);
    if (lane == 0) sc[r - r0] = ids[r] >= 0 ? acc : -INFINITY;
  }
  __syncthreads();

  if (warp == 0)
    emit_range_topk(sc, ids, r0, r1 - r0,
                    ((static_cast<size_t>(b) * P + p) * S + z) * k, p, cap,
                    k, lane, cand_vals, cand_keys, cand_ids);
}

// int8 residual codes: score = (q_lo.v8_lo)*s_lo + (q_hi.v8_hi)*s_hi + bias.
template <bool kVec>
__global__ void ivf_bucket_int8_kernel(const float* __restrict__ q,
                                       const int* __restrict__ probe,
                                       const signed char* __restrict__ codes,
                                       const float* __restrict__ scales,
                                       const float* __restrict__ bias,
                                       const int* __restrict__ bucket_ids,
                                       float* __restrict__ cand_vals,
                                       int* __restrict__ cand_keys,
                                       int* __restrict__ cand_ids, int P,
                                       int C, int cap, int d, int k, int S) {
  extern __shared__ float smem[];
  float* qs = smem;        // [d]
  float* sc = smem + d;    // [rows of the range]
  const int p = blockIdx.x / S;
  const int z = blockIdx.x % S;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = min(max(probe[static_cast<size_t>(b) * P + p], 0), C - 1);
  const signed char* vecs = codes + static_cast<size_t>(c) * cap * d;
  const float* scl = scales + static_cast<size_t>(c) * cap * 2;
  const int* ids = bucket_ids + static_cast<size_t>(c) * cap;
  const float bb = bias[static_cast<size_t>(b) * P + p];
  int r0, r1;
  row_range(cap, S, z, &r0, &r1);

  for (int i = threadIdx.x; i < d; i += kThreads)
    qs[i] = q[static_cast<size_t>(b) * d + i];
  __syncthreads();

  for (int r = r0 + warp; r < r1; r += kWarps) {
    const float2 dots =
        row_dot_int8<kVec>(vecs + static_cast<size_t>(r) * d, qs, d, lane);
    if (lane == 0) {
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(dots.x, scl[2 * r]),
                                          __fmul_rn(dots.y, scl[2 * r + 1])),
                                bb);
      sc[r - r0] = ids[r] >= 0 ? s : -INFINITY;
    }
  }
  __syncthreads();

  if (warp == 0)
    emit_range_topk(sc, ids, r0, r1 - r0,
                    ((static_cast<size_t>(b) * P + p) * S + z) * k, p, cap,
                    k, lane, cand_vals, cand_keys, cand_ids);
}

}  // namespace

extern "C" {

// Pass 1, f32 buckets, each cut into S row ranges: cand_* are [B, P*S*k].
int has_ivf_scan(const float* q, const int* probe, const float* bucket_vecs,
                 const int* bucket_ids, float* cand_vals, int* cand_keys,
                 int* cand_ids, int B, int P, int C, int cap, int d, int k,
                 int S, void* stream) {
  const size_t smem =
      static_cast<size_t>(d + (cap + S - 1) / S) * sizeof(float);
  const bool vec =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(bucket_vecs) % 16 == 0;
  const dim3 grid(P * S, B);
  auto kernel = vec ? ivf_bucket_kernel<true> : ivf_bucket_kernel<false>;
  cudaError_t err = has_kernels::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, probe, bucket_vecs, bucket_ids, cand_vals, cand_keys, cand_ids, P, C,
      cap, d, k, S);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1, int8 residual codes [C,cap,d] with scales [C,cap,2] and the
// probe bias [B,P]; d even; S row ranges per bucket.  cand_* are
// [B, P*S*k].
int has_ivf_scan_int8(const float* q, const int* probe,
                      const signed char* codes, const float* scales,
                      const float* bias, const int* bucket_ids,
                      float* cand_vals, int* cand_keys, int* cand_ids, int B,
                      int P, int C, int cap, int d, int k, int S,
                      void* stream) {
  const size_t smem =
      static_cast<size_t>(d + (cap + S - 1) / S) * sizeof(float);
  const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const dim3 grid(P * S, B);
  auto kernel =
      vec ? ivf_bucket_int8_kernel<true> : ivf_bucket_int8_kernel<false>;
  cudaError_t err = has_kernels::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, probe, codes, scales, bias, bucket_ids, cand_vals, cand_keys,
      cand_ids, P, C, cap, d, k, S);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: [rows, m] candidates -> [rows, k].
int has_ivf_merge(const float* in_vals, const int* in_keys, const int* in_pay,
                  int rows, int m, int k, float* out_vals, int* out_keys,
                  int* out_pay, void* stream) {
  return has_kernels::launch_topk_merge(in_vals, in_keys, in_pay, rows, m, k,
                                        out_vals, out_keys, out_pay,
                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
