// RRF fusion + near-duplicate diversification + rerank scores of a hybrid
// pool.
//
// Replaces src/repro/kernels/fused_rerank.py::_fused_kernel (Pallas, TPU):
// one query's pool of P = kd dense + kl lexical slots (-1 = invalid) ->
//   mass[i]   = sum over slots j holding the same valid id of 1/(rrf_k +
//               rank_j), in slot order, on the id's first slot (0 elsewhere
//               and on invalid slots);
//   rscore[i] = vec_i . q;
// then, with diversify, cosines of the pool (norms floored at 1e-12) and P
// greedy rounds: the slot of largest remaining mass (lowest on ties) is
// kept if its mass > 0 and its cosine to every kept slot < diversify_sim.
// Kept slots output their mass, the others -inf.  The caller's stable
// two-key sort makes the final order (mass desc, rscore desc, slot).
//
// What bounds it on an H100: the launch.  At the cloud stage's shape (B=1,
// P=20, d=768) it reads 61 KB and does about 0.6 M flops (the 20 x 20
// cosines dominate): tens of nanoseconds of either.
//
// Design: one block of 256 threads per query.  The pool's vectors are
// staged in shared memory with coalesced loads; masses by one thread per
// slot, with rounded, uncontracted adds in slot order (bit-equal to the
// plain version); rscores and norms by one warp per slot; with diversify,
// the vectors are normalized in place and the cosines of the pairs i <= j
// computed by one warp per pair; the greedy rounds run in warp 0, one or
// two slots per lane (P <= 64), with shuffle reductions for the argmax and
// the largest cosine to the kept slots.
#include <cuda_runtime.h>
#include <math.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void fused_kernel(const float* __restrict__ q,
                             const int* __restrict__ pool_ids,
                             const float* __restrict__ pool_vecs,
                             float* __restrict__ out_mass,
                             float* __restrict__ out_rscore, int P, int kd,
                             int d, float rrf_k, int diversify, float dsim) {
  extern __shared__ float fsmem[];
  float* qs = fsmem;                 // [d]
  float* raw = qs + d;               // [P] RRF mass of each slot
  float* mass = raw + P;             // [P]
  float* norm = mass + P;            // [P]
  int* ids = reinterpret_cast<int*>(norm + P);      // [P]
  float* vs = reinterpret_cast<float*>(ids + P);    // [P*d] the pool
  float* sims = vs + static_cast<size_t>(P) * d;    // [P*P] (diversify)
  const size_t b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* vecs = pool_vecs + b * P * d;

  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = q[b * d + i];
#pragma unroll 8
  for (int x = threadIdx.x; x < P * d; x += kThreads) vs[x] = vecs[x];
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int id = pool_ids[b * P + i];
    const int rank = i < kd ? i : i - kd;
    ids[i] = id;
    raw[i] = id >= 0 ? __fdiv_rn(1.f, __fadd_rn(rrf_k, static_cast<float>(
                                                          rank)))
                     : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int id = ids[i];
    bool first = true;
    float m = 0.f;
    for (int j = 0; j < P; ++j) {
      const bool same = id >= 0 && ids[j] == id;
      first &= !(same && j < i);
      m = __fadd_rn(m, same ? raw[j] : 0.f);
    }
    mass[i] = (first && id >= 0) ? m : 0.f;
  }
  for (int i = warp; i < P; i += kWarps) {
    const float* v = vs + static_cast<size_t>(i) * d;
    float rs = 0.f, ss = 0.f;
#pragma unroll 4
    for (int e = lane; e < d; e += 32) {
      const float x = v[e];
      rs = fmaf(x, qs[e], rs);
      ss = fmaf(x, x, ss);
    }
    rs = warp_sum(rs);
    ss = warp_sum(ss);
    if (lane == 0) {
      out_rscore[b * P + i] = rs;
      norm[i] = fmaxf(__fsqrt_rn(ss), 1e-12f);
    }
  }
  __syncthreads();

  if (!diversify) {
    for (int i = threadIdx.x; i < P; i += kThreads)
      out_mass[b * P + i] = mass[i] > 0.f ? mass[i] : -INFINITY;
    return;
  }
  for (int x = threadIdx.x; x < P * d; x += kThreads)
    vs[x] = __fdiv_rn(vs[x], norm[x / d]);
  __syncthreads();
  for (int pair = warp; pair < P * P; pair += kWarps) {
    const int i = pair / P, j = pair % P;
    if (j < i) continue;                       // the pair i <= j fills both
    const float* a = vs + static_cast<size_t>(i) * d;
    const float* c = vs + static_cast<size_t>(j) * d;
    float acc = 0.f;
#pragma unroll 4
    for (int e = lane; e < d; e += 32) acc = fmaf(a[e], c[e], acc);
    acc = warp_sum(acc);
    if (lane == 0) sims[i * P + j] = sims[j * P + i] = acc;
  }
  __syncthreads();

  if (warp == 0) {
    // slots lane and lane + 32; absent slots hold -1 and never win
    float rem0 = lane < P ? mass[lane] : -1.f;
    float rem1 = lane + 32 < P ? mass[lane + 32] : -1.f;
    bool sel0 = false, sel1 = false;
    for (int round = 0; round < P; ++round) {
      // the slot of largest remaining mass, the lowest on ties
      float bv = rem0;
      int bi = lane;
      if (rem1 > bv) { bv = rem1; bi = lane + 32; }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      const int c = bi;
      // its largest cosine to a kept slot (-inf when none is kept)
      float ms = -INFINITY;
      if (sel0) ms = sims[c * P + lane];
      if (sel1) ms = fmaxf(ms, sims[c * P + lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ms = fmaxf(ms, __shfl_xor_sync(0xffffffffu, ms, off));
      const bool keep = bv > 0.f && ms < dsim;
      if (c == lane) { sel0 |= keep; rem0 = 0.f; }
      if (c == lane + 32) { sel1 |= keep; rem1 = 0.f; }
    }
    if (lane < P) out_mass[b * P + lane] = sel0 ? mass[lane] : -INFINITY;
    if (lane + 32 < P)
      out_mass[b * P + lane + 32] = sel1 ? mass[lane + 32] : -INFINITY;
  }
}

}  // namespace

extern "C" {

// out_mass / out_rscore [B, P]; P <= 64.
int has_fused_rerank(const float* q, const int* pool_ids,
                     const float* pool_vecs, float* out_mass,
                     float* out_rscore, int B, int P, int kd, int d,
                     float rrf_k, int diversify, float dsim, void* stream) {
  const size_t smem = 4 * (static_cast<size_t>(d) + 4 * P +
                           static_cast<size_t>(P) * d +
                           (diversify ? P * P : 0));
  cudaError_t err = has_kernels::allow_smem(fused_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, pool_ids, pool_vecs, out_mass, out_rscore, P, kd, d, rrf_k,
      diversify, dsim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
