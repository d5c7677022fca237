// Fold a chunk of full retrievals into the HaS rings (Algorithm 1 line 16)
// in three launches, whatever the number of rows.
//
// Replaces no Pallas kernel: the JAX package folds a batch by lax.scan over
// _cache_update_impl (src/repro/core/has.py:577-599), one row after
// another.  The result is that sequential fold over the unmasked rows in
// order, each row into its tenant's partition:
//   * query ring: the r-th row of a tenant writes slot (q_ptr + r) % H;
//   * doc ring: a row inserts, in result order, each id that is >= 0, not
//     in the ring as it stands at the row's start and not earlier in the
//     same row; the j-th insertion of the chunk goes to (d_ptr + j) % Dc;
//   * both pointers count up without wrapping.
// An id is in the ring at a row's start, with n insertions made by the
// earlier rows of the chunk, when (a) it sat at entry slot s and insertion
// (s - d_ptr) mod Dc has not been made yet, i.e. that offset is >= n, or
// (b) an earlier row inserted it at insertion index j and insertion j + Dc
// has not been made yet, i.e. j + Dc >= n.  So an id evicted earlier in the
// chunk is new again, and one inserted earlier is present.  Every slot takes
// one final writer: the largest insertion (row) index that lands on it.
//
// What bounds it on an H100: latency.  At the serving shape (B=64, k=10,
// Dc=50,000, d=768) it reads the 200 KB id ring and writes at most 704 rows
// of 3 KB, about 2.4 MB (under a microsecond of bytes); the rest is the
// dependence of each row on the insertions of the rows before it.
//
// Design, three launches on the caller's stream and no host wait:
//   1. fold_lookup_kernel: every (tenant, tile of ring slots, group of
//      candidates).  A thread holds one candidate id and scans the tile in
//      shared memory; for a match at slot s it keeps the largest offset
//      (s - d_ptr) mod Dc, the entry slot that survives longest, and
//      atomicMax-es offset + 1 into life[candidate] (scratch, zero between
//      calls: the walk resets what it reads).
//   2. fold_walk_kernel: one CTA per tenant.  It lists the tenant's rows in
//      order, loads their candidates with their life into shared memory and
//      gives each distinct id an entry of a shared hash table (the last
//      insertion index of the id in this chunk).  Then warp 0 walks the
//      rows, k lanes a row: duplicates earlier in the row by __match_any,
//      (a) and (b) above from life and the table, the insertion indices by
//      a ballot.  Last, every thread marks the final writers (insertion j
//      is final when j + Dc >= N, row r when r + H >= R) in dslot / qslot,
//      and thread 0 advances the tenant's pointers.
//   3. fold_copy_kernel: a warp per candidate and per row.  Each final
//      writer copies its id and its 3 KB row (the doc row from full_vecs,
//      or read from the corpus by id) into its slot; a row writes its query
//      embedding, its k ids and its valid bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kLookupThreads = 128;   // candidates a lookup CTA holds
constexpr int kTile = 1024;           // ring slots a lookup CTA scans
constexpr int kWalkThreads = 256;
constexpr int kCopyWarps = 8;
constexpr int kNever = INT_MIN / 2;   // "no insertion" (j + Dc < 0 <= n)

struct Rings {
  float* query_emb;                   // [T, H, d]
  int* query_doc_ids;                 // [T, H, k]
  unsigned char* query_valid;         // [T, H]
  int* q_ptr;                         // [T]
  float* doc_emb;                     // [T, Dc, d]
  int* doc_ids;                       // [T, Dc], -1 empty
  int* d_ptr;                         // [T]
  int T, H, Dc, d, k;
};

struct Chunk {
  const float* q;                     // [B, d]
  const int* ids;                     // [B, k]
  const float* vecs;                  // [B, k, d], or null: read corpus
  const float* corpus;                // [N, d]
  const unsigned char* mask;          // [B], or null: every row
  const int* tids;                    // [B], or null: tenant 0
  int B;
};

__device__ __forceinline__ int tenant_of(const Chunk& c, int b) {
  return c.tids == nullptr ? 0 : c.tids[b];
}

__device__ __forceinline__ bool row_of(const Chunk& c, int b, int t) {
  return (c.mask == nullptr || c.mask[b]) && tenant_of(c, b) == t;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__global__ void __launch_bounds__(kLookupThreads)
fold_lookup_kernel(Rings r, Chunk c, int* life) {
  __shared__ int4 tile4[kTile / 4];
  int* tile = reinterpret_cast<int*>(tile4);
  const int t = blockIdx.z;
  const int cand = blockIdx.y * kLookupThreads + threadIdx.x;
  int x = -1;
  if (cand < c.B * r.k && row_of(c, cand / r.k, t)) x = c.ids[cand];
  if (!__syncthreads_or(x >= 0)) return;
  const int s0 = blockIdx.x * kTile;
  const int n = min(kTile, r.Dc - s0);
  const int* ring = r.doc_ids + static_cast<size_t>(t) * r.Dc + s0;
  for (int i = threadIdx.x; i < kTile; i += kLookupThreads)
    tile[i] = i < n ? ring[i] : -1;
  __syncthreads();
  if (x < 0) return;
  const int dp = r.d_ptr[t] % r.Dc;
  int best = -1;
  for (int i4 = 0; i4 < kTile / 4; ++i4) {
    const int4 v = tile4[i4];
    if (v.x == x || v.y == x || v.z == x || v.w == x) {   // rare: few ids
      const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e[j] != x) continue;
        const int s = s0 + 4 * i4 + j;
        best = max(best, s >= dp ? s - dp : s - dp + r.Dc);
      }
    }
  }
  if (best >= 0) atomicMax(&life[cand], best + 1);
}

__global__ void __launch_bounds__(kWalkThreads)
fold_walk_kernel(Rings r, Chunk c, int* life, int* qslot, int* dslot,
                 int P) {
  extern __shared__ int sm[];
  __shared__ int s_nrows, s_n;
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const int B = c.B, k = r.k, nc = B * k;
  int* s_ids = sm;                    // [nc] this tenant's candidates
  int* s_life = s_ids + nc;           // [nc] entry offset + 1, 0: absent
  int* s_h = s_life + nc;             // [nc] the id's hash entry
  int* s_ins = s_h + nc;              // [nc] insertion index, -1: none
  int* s_rows = s_ins + nc;           // [B] this tenant's rows in order
  int* s_key = s_rows + B;            // [P] ids, -1: empty entry
  int* s_last = s_key + P;            // [P] last insertion index of the id
  const long long qp = r.q_ptr[t], dp = r.d_ptr[t];

  if (tid < 32) {                     // the tenant's rows, in order
    int cnt = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const bool mine = b < B && row_of(c, b, t);
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      if (mine) s_rows[cnt + __popc(bal & lanes_below(lane))] = b;
      cnt += __popc(bal);
    }
    if (lane == 0) s_nrows = cnt;
  }
  for (int i = tid; i < P; i += kWalkThreads) {
    s_key[i] = -1;
    s_last[i] = kNever;
  }
  __syncthreads();
  const int nrows = s_nrows, m = nrows * k;
  const int shift = 32 - (31 - __clz(P));     // P is a power of two >= 2
  for (int i = tid; i < m; i += kWalkThreads) {
    const int cand = s_rows[i / k] * k + i % k;
    const int x = c.ids[cand];
    s_ids[i] = x;
    s_life[i] = life[cand];
    life[cand] = 0;                   // zero again for the next call
    s_ins[i] = -1;
    if (x < 0) continue;
    unsigned h = (static_cast<unsigned>(x) * 0x9E3779B1u) >> shift;
    for (;;) {                        // at most nc ids in 2 * nc entries
      const int prev = atomicCAS(&s_key[h], -1, x);
      if (prev == -1 || prev == x) break;
      h = (h + 1) & (P - 1);
    }
    s_h[i] = static_cast<int>(h);
  }
  __syncthreads();

  const int dc = r.Dc;
  if (tid < 32) {                     // the walk: warp 0, a row at a time
    int n = 0;                        // insertions of the earlier rows
    for (int row = 0; row < nrows; ++row) {
      const int* ids = s_ids + row * k;
      int made = 0;                   // insertions of this row so far
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane, i = row * k + j;
        const int x = j < k ? ids[j] : -1;
        bool dup = (__match_any_sync(0xffffffffu, x) & lanes_below(lane))
                   != 0;
        for (int jj = 0; jj < j0 && !dup && x >= 0; ++jj)
          dup = ids[jj] == x;
        bool fresh = false;
        if (x >= 0 && !dup)
          fresh = s_life[i] - 1 < n && s_last[s_h[i]] + dc < n;
        const unsigned bal = __ballot_sync(0xffffffffu, fresh);
        if (fresh) {
          const int ins = n + made + __popc(bal & lanes_below(lane));
          s_ins[i] = ins;
          s_last[s_h[i]] = ins;       // a repeat of x in this row is a dup
        }
        made += __popc(bal);
        __syncwarp();
      }
      n += made;
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();

  const int N = s_n;
  for (int i = tid; i < m; i += kWalkThreads) {
    const int ins = s_ins[i];
    dslot[s_rows[i / k] * k + i % k] =
        ins >= 0 && ins + dc >= N ? static_cast<int>((dp + ins) % dc) : -1;
  }
  for (int row = tid; row < nrows; row += kWalkThreads)
    qslot[s_rows[row]] =
        row + r.H >= nrows ? static_cast<int>((qp + row) % r.H) : -1;
  if (t == 0) {                       // rows no tenant walks write nothing
    for (int b = tid; b < B; b += kWalkThreads) {
      const int tb = tenant_of(c, b);
      if ((c.mask == nullptr || c.mask[b]) && tb >= 0 && tb < r.T) continue;
      qslot[b] = -1;
      for (int j = 0; j < k; ++j) dslot[b * k + j] = -1;
    }
  }
  if (tid == 0) {                     // every thread read both pointers
    r.q_ptr[t] = static_cast<int>(qp + nrows);
    r.d_ptr[t] = static_cast<int>(dp + N);
  }
}

template <bool V4>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int d,
                                         int lane) {
  if (V4) {
    float4* o = reinterpret_cast<float4*>(dst);
    const float4* s = reinterpret_cast<const float4*>(src);
    for (int i = lane; i < d / 4; i += 32) o[i] = s[i];
  } else {
    for (int i = lane; i < d; i += 32) dst[i] = src[i];
  }
}

template <bool V4>
__global__ void __launch_bounds__(32 * kCopyWarps)
fold_copy_kernel(Rings r, Chunk c, const int* qslot, const int* dslot) {
  const int w = blockIdx.x * kCopyWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nc = c.B * r.k;
  const size_t d = r.d;
  if (w < nc) {                       // a candidate: its doc row
    const int slot = dslot[w];
    if (slot < 0) return;
    const int x = c.ids[w];
    const size_t row = static_cast<size_t>(tenant_of(c, w / r.k)) * r.Dc
                       + slot;
    if (lane == 0) r.doc_ids[row] = x;
    copy_row<V4>(r.doc_emb + row * d,
                 c.vecs != nullptr ? c.vecs + static_cast<size_t>(w) * d
                                   : c.corpus + static_cast<size_t>(x) * d,
                 r.d, lane);
  } else if (w < nc + c.B) {          // a row: its query entry
    const int b = w - nc;
    const int slot = qslot[b];
    if (slot < 0) return;
    const size_t row = static_cast<size_t>(tenant_of(c, b)) * r.H + slot;
    for (int j = lane; j < r.k; j += 32)
      r.query_doc_ids[row * r.k + j] = c.ids[b * r.k + j];
    if (lane == 0) r.query_valid[row] = 1;
    copy_row<V4>(r.query_emb + row * d, c.q + static_cast<size_t>(b) * d,
                 r.d, lane);
  }
}

}  // namespace

extern "C" {

// The rings (stacked [T, ...] or one tenant's views), the chunk, scratch
// life [B*k] (zero between calls), qslot [B] and dslot [B*k]; P the walk's
// hash entries (a power of two >= 2*B*k), smem its dynamic shared memory
// (4 * (4*B*k + B + 2*P) bytes), vec4 when d % 4 == 0 and every row base
// is 16-byte aligned.
int has_cache_fold(float* query_emb, int* query_doc_ids,
                   unsigned char* query_valid, int* q_ptr, float* doc_emb,
                   int* doc_ids, int* d_ptr, const float* q, const int* ids,
                   const float* vecs, const float* corpus,
                   const unsigned char* mask, const int* tids, int* life,
                   int* qslot, int* dslot, int T, int H, int Dc, int d, int k,
                   int B, int P, int smem, int vec4, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rings r{query_emb, query_doc_ids, query_valid, q_ptr, doc_emb,
                doc_ids, d_ptr, T, H, Dc, d, k};
  const Chunk c{q, ids, vecs, corpus, mask, tids, B};
  const cudaError_t err = has_kernels::allow_smem(fold_walk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = B * k;
  const dim3 grid((Dc + kTile - 1) / kTile,
                  (nc + kLookupThreads - 1) / kLookupThreads, T);
  fold_lookup_kernel<<<grid, kLookupThreads, 0, st>>>(r, c, life);
  fold_walk_kernel<<<T, kWalkThreads, smem, st>>>(r, c, life, qslot, dslot,
                                                  P);
  const int blocks = (nc + B + kCopyWarps - 1) / kCopyWarps;
  if (vec4)
    fold_copy_kernel<true><<<blocks, 32 * kCopyWarps, 0, st>>>(r, c, qslot,
                                                                dslot);
  else
    fold_copy_kernel<false><<<blocks, 32 * kCopyWarps, 0, st>>>(r, c, qslot,
                                                                 dslot);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
