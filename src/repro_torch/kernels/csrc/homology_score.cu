// Homology scores of draft id lists against the cached query table, and
// each draft's best row, in one launch.
//
// Replaces src/repro/kernels/homology_score.py::_homology_kernel (Pallas,
// TPU) and the reduction its callers run after it (first argmax and the
// gather of the best score, src/repro/core/has.py:369-371): for draft b
// and cached row h, the fraction of the draft's ids >= 0 found among the
// row's k ids (count / k), or with draft_weights the sum of the matched
// slots' weights.  Rows with valid[h] == 0, or with row_group[h] !=
// q_group[b] when groups are given, score 0.  With best/slot, also each
// draft's largest score and the lowest row that holds it (row 0 and 0.0
// when every row scores 0).
//
// What bounds it on an H100: latency, not bytes or operations.  At the
// main-path shape (B=1, H=5000, k=10) it reads the 200 KB id table once
// and does 500k int compares: well under a microsecond of either.
//
// Design: a grid of (h tiles of kThreads rows) x (b tiles of tb drafts),
// planned by the wrapper so that B=1 and B=64 both spread over the SMs.
// Each thread loads its cached row once, with vector loads, into
// registers (k is a template parameter for the widths in use; one generic
// route reads the row from L1 for any other k), and scores it against
// its CTA's drafts, staged in shared memory; scores are written coalesced
// along h, every element, so the output needs no clearing.  The score is
// (float)count / (float)k with IEEE division, exactly as the reference
// computes it: at tau = 0.2 and k = 10, 2/10 == 0.2f and accept is the
// strict best > tau, so any other rounding would flip accept bits.  For
// the best row, each warp reduces (score order bits, ~h) per draft by two
// redux.sync, each CTA combines its warps and writes its partial to
// scratch, and the last CTA of each b tile to arrive (an atomic ticket,
// reset by that CTA) merges the partials.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using has_kernels::kFull;
using has_kernels::order_bits;
using has_kernels::from_order_bits;

constexpr int kThreads = 128;         // cached rows a CTA, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 32;          // drafts a CTA

struct Hom {
  const int* draft;                   // [B, k]
  const int* cache;                   // [H, k]
  const unsigned char* valid;         // [H]
  const float* weights;               // [B, k] or null
  const int* row_group;               // [H] or null (with q_group)
  const int* q_group;                 // [B] or null
  float* out;                         // [B, H]
  float* best;                        // [B] or null (with slot)
  int* slot;                          // [B]
  int* tickets;                       // [n b tiles], zero between calls
  unsigned long long* part;           // [B, n h tiles]
  int B, H, k, tb;
  int vec;                            // cache 16-byte aligned
};

// The cached row's K ids, in vector loads where K and the row allow.
template <int K>
__device__ __forceinline__ void load_row(const int* src, bool vec,
                                         int (&row)[K]) {
  if constexpr (K % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < K / 4; ++i) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src) + i);
        row[4 * i] = v.x;
        row[4 * i + 1] = v.y;
        row[4 * i + 2] = v.z;
        row[4 * i + 3] = v.w;
      }
      return;
    }
  } else if constexpr (K % 2 == 0) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(src) + i);
        row[2 * i] = v.x;
        row[2 * i + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) row[i] = __ldg(src + i);
}

// Matched draft slots of one row: their count and their weights' sum, in
// slot order.  K == 0: the generic route, k at run time, the row read
// from L1 for each draft id.
template <int K>
__device__ __forceinline__ void match(const int (&row)[K > 0 ? K : 1],
                                      const int* row_mem, const int* sd,
                                      const float* sw, int k, int& count,
                                      float& mass) {
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int id = sd[i];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < K; ++j) hit |= row[j] == id;
      if (hit && id >= 0) {
        ++count;
        if (sw) mass += sw[i];
      }
    }
  } else {
    for (int i = 0; i < k; ++i) {
      const int id = sd[i];
      bool hit = false;
      for (int j = 0; j < k; ++j) hit |= __ldg(row_mem + j) == id;
      if (hit && id >= 0) {
        ++count;
        if (sw) mass += sw[i];
      }
    }
  }
}

// The larger of two (order bits, ~h) keys as two redux.sync: the score's
// bits, then ~h among the lanes that hold them.  0 is an empty key.
__device__ __forceinline__ unsigned long long warp_best(
    unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned wh = __reduce_max_sync(kFull, hi);
  const unsigned wl = __reduce_max_sync(
      kFull, hi == wh ? static_cast<unsigned>(key) : 0u);
  return static_cast<unsigned long long>(wh) << 32 | wl;
}

template <int K>
__global__ void __launch_bounds__(kThreads) homology_kernel(const Hom a) {
  extern __shared__ int hsmem[];
  const int k = K > 0 ? K : a.k, tb = a.tb;
  int* s_draft = hsmem;                                        // [tb][k]
  float* s_w = reinterpret_cast<float*>(s_draft + tb * k);     // [tb][k]
  int* s_qg = reinterpret_cast<int*>(s_w + tb * k);            // [tb]
  __shared__ unsigned long long s_best[kWarps][kMaxTile];
  __shared__ int s_last;
  const int b0 = blockIdx.y * tb;
  const int nt = min(tb, a.B - b0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int x = tid; x < nt * k; x += kThreads) {
    s_draft[x] = a.draft[static_cast<size_t>(b0) * k + x];
    if (a.weights) s_w[x] = a.weights[static_cast<size_t>(b0) * k + x];
  }
  if (a.q_group)
    for (int t = tid; t < nt; t += kThreads) s_qg[t] = a.q_group[b0 + t];

  const int h = blockIdx.x * kThreads + tid;
  const bool in = h < a.H;
  const bool ok = in && a.valid[h] != 0;
  const int rg = ok && a.row_group ? a.row_group[h] : 0;
  const int* row_mem = a.cache + static_cast<size_t>(in ? h : 0) * k;
  int row[K > 0 ? K : 1];
  if constexpr (K > 0)
    if (ok) load_row<K>(row_mem, a.vec, row);
  __syncthreads();

  const bool reduce = a.best != nullptr;
  for (int t = 0; t < nt; ++t) {
    float s = 0.f;
    if (ok && (!a.q_group || rg == s_qg[t])) {
      int count = 0;
      float mass = 0.f;
      match<K>(row, row_mem, s_draft + t * k,
               a.weights ? s_w + t * k : nullptr, k, count, mass);
      s = a.weights ? mass
                    : __fdiv_rn(static_cast<float>(count),
                                static_cast<float>(k));
    }
    if (in) a.out[static_cast<size_t>(b0 + t) * a.H + h] = s;
    if (reduce) {
      const unsigned long long key =
          in ? static_cast<unsigned long long>(order_bits(s)) << 32 |
                   ~static_cast<unsigned>(h)
             : 0ull;
      const unsigned long long w = warp_best(key);
      if (lane == 0) s_best[warp][t] = w;
    }
  }
  if (!reduce) return;
  __syncthreads();
  const int n_h = gridDim.x;
  if (tid < nt) {
    unsigned long long best = 0ull;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) best = max(best, s_best[w][tid]);
    a.part[static_cast<size_t>(b0 + tid) * n_h + blockIdx.x] = best;
  }
  if (!has_kernels::arrive(a.tickets + blockIdx.y, n_h, &s_last)) return;

  // the last CTA of this b tile: each draft's partials, by warps
  for (int t = warp; t < nt; t += kWarps) {
    const unsigned long long* p = a.part + static_cast<size_t>(b0 + t) * n_h;
    unsigned long long best = 0ull;
    for (int j = lane; j < n_h; j += 32) best = max(best, __ldcg(p + j));
    best = warp_best(best);
    if (lane == 0) {
      a.best[b0 + t] = from_order_bits(static_cast<unsigned>(best >> 32));
      a.slot[b0 + t] = static_cast<int>(~static_cast<unsigned>(best));
    }
  }
}

template <int K>
cudaError_t launch(const Hom& a, int n_h, int n_b, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.tb) * (2 * a.k + 1) * 4;
  homology_kernel<K><<<dim3(n_h, n_b), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows a CTA scores (the wrapper plans the h tiles with it).
int has_homology_rows_per_cta() { return kThreads; }

// out [B, H] f32; weights, row_group and q_group may be null (the two
// groups together); best [B] f32 and slot [B] int32 may be null together,
// and then tickets and part are not used.  tb drafts a CTA (<= 32); part
// holds B * ceil(H / kThreads) 64-bit words; tickets ceil(B / tb) zeroed
// ints.
int has_homology_score(const int* draft, const int* cache,
                       const unsigned char* valid, const float* weights,
                       const int* row_group, const int* q_group, float* out,
                       float* best, int* slot, int* tickets, void* part,
                       int B, int H, int k, int tb, void* stream) {
  if (tb < 1 || tb > kMaxTile || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hom a{draft, cache, valid, weights, row_group, q_group, out, best,
              slot, tickets, static_cast<unsigned long long*>(part), B, H, k,
              tb, reinterpret_cast<uintptr_t>(cache) % 16 == 0};
  const int n_h = (H + kThreads - 1) / kThreads, n_b = (B + tb - 1) / tb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(a, n_h, n_b, st); break;
    case 10: err = launch<10>(a, n_h, n_b, st); break;
    case 32: err = launch<32>(a, n_h, n_b, st); break;
    default: err = launch<0>(a, n_h, n_b, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
