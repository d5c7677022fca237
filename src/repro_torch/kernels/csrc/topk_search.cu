// Streaming inner-product top-k over a corpus: the HaS cache channel.
//
// Replaces src/repro/kernels/topk_search.py::_topk_kernel (Pallas, TPU):
// q [B,d] @ corpus[N,d]^T with masks (valid rows, optional row_group ==
// q_group) and a running top-k carried across sequential corpus tiles.
//
// What bounds it on an H100: at B=1, bytes: the main path's ring (N=50,000
// slots, d=768, f32) is 153.6 MB, ~46 us at 3.35 TB/s, and its 77 MFLOP
// are nothing.  At B=64 the 4.9 GFLOP of f32 FMAs (no TF32, no tensor
// cores: the port's scores are full f32) take ~73 us at the CUDA cores'
// 67 TFLOP/s, over the ~46 us of bytes.
//
// Design (topk_scan_kernel):
// - A persistent grid of about one block per SM (per query tile) splits the
//   corpus into even, contiguous row ranges, each walked in row tiles, so
//   every SM streams the same number of rows.  A block owns a query tile
//   of up to 64 queries, so each corpus byte is read once per 64 queries.
// - d is cut into slabs; each slab of the tile's rows and queries is
//   copied by 16-byte cp.async into a ring in shared memory (3 stages of
//   64 floats, or 4 of 32 for the 8-query tile), the stream running on
//   across tile boundaries, so two or three slabs (64-110 KB) stay in
//   flight per SM while one is computed.
// - Each thread keeps a TQ x TR register tile of f32 accumulators (8x4 at
//   B > 8: every float4 from shared memory feeds 8 or 16 FMAs; 1x1 at
//   B = 1, where the kernel is a stream) and sums d in order with fmaf.
//   Rows sit at a stride of DK + 4 floats, so the float4 reads of 8
//   consecutive rows hit 8 different bank groups.
// - After a tile's last slab the scores, masked to -inf, go to shared
//   memory, and one warp per query admits only scores that beat its
//   running k-th (score descending, then the lower row) into a sorted
//   list in shared memory, 32 scores at a time by rank; while the list
//   is not full (the first tile), k rounds of a warp max fill it.  Each
//   block thus writes one top-k per query: gridDim.x * k candidates a
//   query (~1,300 at k = 10), as the TPU carries one top-k across its
//   grid.
// - topk_block_merge_kernel: one 256-thread block per query.  Each warp
//   merges up to 32 of the blocks' sorted lists by their heads (a warp
//   max per pick), then warp 0 merges the 8 warps' lists the same way.
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using has_kernels::better;
using has_kernels::kFull;
using has_kernels::warp_merge;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 8 warps: WR warps across rows, 8 / WR across queries; slabs of DK
// floats of d in a ring of STAGES
template <int TQ, int WR, int TR, int DK, int STAGES>
struct Tile {
  static constexpr int WQ = kWarps / WR;
  static constexpr int QB = WQ * TQ;    // queries per block
  static constexpr int R = WR * 32 * TR;  // rows per tile
  static constexpr int kLd = DK + 4;      // smem row stride, floats
  static constexpr int kStage = (QB + R) * kLd;  // floats
  static constexpr int kStages = STAGES;
  static constexpr int kDK = DK;
  static constexpr int kTQ = TQ, kWR = WR, kTR = TR;
};

// The three query tiles (wrapper's `tile`): 1 query x 256 rows, 8 x 256,
// 64 x 128.  256-byte slabs where shared memory allows (fewer, longer
// DRAM bursts per row); 128-byte ones for tile 1, which must hold 8 lists
// of up to 1024 entries.
using Tile0 = Tile<1, 8, 1, 64, 3>;
using Tile1 = Tile<8, 8, 1, 32, 4>;
using Tile2 = Tile<8, 1, 4, 64, 3>;

template <class T>
size_t scan_smem_bytes(int k) {
  return sizeof(float) * (static_cast<size_t>(T::kStages) * T::kStage +
                          static_cast<size_t>(T::QB) * T::R) +
         static_cast<size_t>(T::QB) * k * (sizeof(float) + sizeof(int));
}

// 16-byte copy into shared memory (zero-filled past src_bytes), with a
// 256-byte L2 prefetch: a row's slab is 256 contiguous bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A list that is not full yet (k <= 32) merges a whole tile row in k
// rounds: each takes the better of the list's head and the best remaining
// score of the row (a warp max over NT = R / 32 scores a lane).  This is
// the block's first tile, where nearly every score would be admitted.
template <int NT>
__device__ void fill_merge(const float* sc, int row0, float* lv, int* lr,
                           int k, int lane) {
  float x[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) x[t] = sc[t * 32 + lane];
  float bv;
  int br;
  auto local_best = [&]() {
    bv = -INFINITY;
    br = INT_MAX;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (x[t] > -INFINITY && better(x[t], row0 + t * 32 + lane, bv, br)) {
        bv = x[t];
        br = row0 + t * 32 + lane;
      }
  };
  local_best();
  const float ov = lane < k ? lv[lane] : -INFINITY;
  const int orr = lane < k ? lr[lane] : INT_MAX;
  float nv = -INFINITY;                   // this lane's new entry
  int nr = INT_MAX;
  int h = 0;                              // the list's head
  for (int j = 0; j < k; ++j) {
    float wv = bv;
    int wr = br;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, wv, off);
      const int r2 = __shfl_xor_sync(kFull, wr, off);
      if (better(v2, r2, wv, wr)) {
        wv = v2;
        wr = r2;
      }
    }
    const float hv = __shfl_sync(kFull, ov, h & 31);
    const int hr = __shfl_sync(kFull, orr, h & 31);
    float pv = wv;
    int pr = wr;
    if (h < k && hv > -INFINITY && !better(wv, wr, hv, hr)) {
      pv = hv;
      pr = hr;
      ++h;
    } else if (wv > -INFINITY && br == wr) {   // this lane's score won
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (row0 + t * 32 + lane == wr) x[t] = -INFINITY;
      local_best();
    }
    if (lane == j) {
      nv = pv;
      nr = pv > -INFINITY ? pr : INT_MAX;
    }
  }
  __syncwarp();
  if (lane < k) {
    lv[lane] = nv;
    lr[lane] = nr;
  }
  __syncwarp();
}

// Admit the scores sc[0..n) of rows row0.. (n % 32 == 0) into the sorted
// list lv/lr [k] of one warp, 32 scores at a time.  The newcomers that
// beat the k-th find their rank among the list by binary search; a list
// entry moves down by the number of newcomers ranked at or above it, a
// newcomer lands at its rank plus the newcomers ahead of it.
__device__ void admit(const float* sc, int n, int row0, float* lv, int* lr,
                      int k, int lane) {
  for (int cb = 0; cb < n; cb += 32) {
    const float v = sc[cb + lane];
    const int r = row0 + cb + lane;
    const bool pass = v > -INFINITY && better(v, r, lv[k - 1], lr[k - 1]);
    const unsigned m = __ballot_sync(kFull, pass);
    if (m == 0) continue;
    int rl = k;                           // list entries ahead of (v, r)
    if (pass) {
      int lo = 0, hi = k - 1;             // (v, r) beats entry k-1
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(lv[mid], lr[mid], v, r))
          lo = mid + 1;
        else
          hi = mid;
      }
      rl = lo;
    }
    int ahead = 0;                        // newcomers ahead of (v, r)
    for (unsigned mm = m; mm; mm &= mm - 1) {
      const int j = __ffs(mm) - 1;
      const float vj = __shfl_sync(kFull, v, j);
      if (pass && better(vj, row0 + cb + j, v, r)) ++ahead;
    }
    int lowest = rl;                      // entries above it stay put
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lowest = min(lowest, __shfl_xor_sync(kFull, lowest, o));
    for (int base = ((k - 1) / 32) * 32; base >= (lowest / 32) * 32;
         base -= 32) {                    // top chunk first: moves go down
      const int i = base + lane;
      int shift = 0;
      for (unsigned mm = m; mm; mm &= mm - 1)
        shift += __shfl_sync(kFull, rl, __ffs(mm) - 1) <= i;
      const bool mv = i < k && shift > 0 && i + shift < k;
      float ev = 0.f;
      int er = 0;
      if (mv) {
        ev = lv[i];
        er = lr[i];
      }
      __syncwarp();
      if (mv) {
        lv[i + shift] = ev;
        lr[i + shift] = er;
      }
      __syncwarp();
    }
    if (pass && rl + ahead < k) {
      lv[rl + ahead] = v;
      lr[rl + ahead] = r;
    }
    __syncwarp();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads, 1)
topk_scan_kernel(const float* __restrict__ q,
                 const float* __restrict__ corpus,
                 const unsigned char* __restrict__ valid,
                 const int* __restrict__ row_group,
                 const int* __restrict__ q_group, float* __restrict__ cand_v,
                 int* __restrict__ cand_r, int B, int N, int d, int k) {
  constexpr int TQ = T::kTQ, WR = T::kWR, TR = T::kTR, kDK = T::kDK;
  constexpr int kLd = T::kLd, kStages = T::kStages;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                             // kStages x [QB+R][kLd]
  float* sc = ring + kStages * T::kStage;         // [QB][R]
  float* lv = sc + T::QB * T::R;                  // [QB][k]
  int* lr = reinterpret_cast<int*>(lv + T::QB * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp / WR, wr = warp % WR;
  const int b0 = blockIdx.y * T::QB;
  const int nq = min(T::QB, B - b0);
  // this block's rows: an even, contiguous share [lo, hi) of the corpus
  const int lo = static_cast<int>(static_cast<long long>(N) * blockIdx.x /
                                  gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(N) *
                                  (blockIdx.x + 1) / gridDim.x);
  const int ns = (d + kDK - 1) / kDK;
  const int n_flat = (hi - lo + T::R - 1) / T::R * ns;  // (tile, slab) steps

  for (int i = tid; i < T::QB * k; i += kThreads) {
    lv[i] = -INFINITY;
    lr[i] = INT_MAX;
  }
  int qg[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int b = b0 + wq * TQ + i;
    qg[i] = (row_group != nullptr && b < B) ? q_group[b] : 0;
  }

  auto load = [&](int f) {
    const int row0 = lo + (f / ns) * T::R;
    const int e0 = (f % ns) * kDK;
    float* st = ring + (f % kStages) * T::kStage;
    for (int i = tid; i < (T::QB + T::R) * (kDK / 4); i += kThreads) {
      const int r = i / (kDK / 4), c4 = (i % (kDK / 4)) * 4;
      const int e = e0 + c4;
      const float* src = q;
      bool ok;
      if (r < T::QB) {
        const int b = b0 + r;
        ok = b < B && e < d;
        if (ok) src = q + static_cast<size_t>(b) * d + e;
      } else {
        const int row = row0 + (r - T::QB);
        ok = row < hi && e < d;
        if (ok) src = corpus + static_cast<size_t>(row) * d + e;
      }
      cp_async16(st + r * kLd + c4, src, ok ? 16 : 0);   // zero-fill
    }
  };
#pragma unroll
  for (int f = 0; f < kStages - 1; ++f) {
    if (f < n_flat) load(f);
    cp_async_commit();
  }

  float acc[TQ][TR];
  bool row_ok[TR];
  int rgrp[TR];
  for (int f = 0; f < n_flat; ++f) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // slab f landed; slot f-1 free
    if (f + kStages - 1 < n_flat) load(f + kStages - 1);
    cp_async_commit();

    const int s = f % ns;
    const int row0 = lo + (f / ns) * T::R;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < TR; ++j) {      // masks, used after the last slab
        const int row = row0 + wr * 32 * TR + lane + 32 * j;
        row_ok[j] = row < hi && valid[row] != 0;
        rgrp[j] = (row_ok[j] && row_group != nullptr) ? row_group[row] : 0;
      }
    }
    const float* st = ring + (f % kStages) * T::kStage;
    const float* qs = st + wq * TQ * kLd;
    const float* cs = st + (T::QB + wr * 32 * TR + lane) * kLd;
#pragma unroll
    for (int e = 0; e < kDK; e += 4) {
      float4 a[TQ], c[TR];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + i * kLd + e);
#pragma unroll
      for (int j = 0; j < TR; ++j)
        c[j] = *reinterpret_cast<const float4*>(cs + j * 32 * kLd + e);
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          float t = acc[i][j];
          t = fmaf(a[i].x, c[j].x, t);
          t = fmaf(a[i].y, c[j].y, t);
          t = fmaf(a[i].z, c[j].z, t);
          t = fmaf(a[i].w, c[j].w, t);
          acc[i][j] = t;
        }
    }
    if (s == ns - 1) {                    // the tile's scores are complete
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qi = wq * TQ + i;
#pragma unroll
        for (int j = 0; j < TR; ++j) {
          const bool ok = row_ok[j] && qi < nq &&
                          (row_group == nullptr || rgrp[j] == qg[i]);
          sc[qi * T::R + wr * 32 * TR + lane + 32 * j] =
              ok ? acc[i][j] : -INFINITY;
        }
      }
      __syncthreads();
      for (int qi = warp; qi < nq; qi += kWarps) {
        if (k <= 32 && !(lv[qi * k + k - 1] > -INFINITY))
          fill_merge<T::R / 32>(sc + qi * T::R, row0, lv + qi * k,
                                lr + qi * k, k, lane);
        else
          admit(sc + qi * T::R, T::R, row0, lv + qi * k, lr + qi * k, k,
                lane);
      }
    }
  }
  cp_async_wait<0>();

  const size_t stride = static_cast<size_t>(gridDim.x) * k;
  for (int qi = warp; qi < nq; qi += kWarps)
    for (int j = lane; j < k; j += 32) {
      const size_t o = static_cast<size_t>(b0 + qi) * stride +
                       static_cast<size_t>(blockIdx.x) * k + j;
      const float v = lv[qi * k + j];
      cand_v[o] = v;
      cand_r[o] = v > -INFINITY ? lr[qi * k + j] : -1;
    }
}

// One block per query: [n_lists sorted lists of k] -> its top-k.
__global__ void __launch_bounds__(kThreads)
topk_block_merge_kernel(const float* __restrict__ cand_v,
                        const int* __restrict__ cand_r, int n_lists, int k,
                        int stage, float* __restrict__ out_v,
                        int* __restrict__ out_r) {
  extern __shared__ __align__(16) float msmem[];
  float* wv = msmem;                              // [kWarps][k]
  int* wrow = reinterpret_cast<int*>(wv + kWarps * k);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t m = static_cast<size_t>(n_lists) * k;
  const size_t b = blockIdx.x;
  const float* src_v = cand_v + b * m;
  const int* src_r = cand_r + b * m;
  if (stage) {                                    // candidates fit: copy
    float* cv = reinterpret_cast<float*>(wrow + kWarps * k);
    int* cr = reinterpret_cast<int*>(cv + m);
    for (size_t i = threadIdx.x; i < m; i += kThreads) {
      cv[i] = src_v[i];
      cr[i] = src_r[i];
    }
    __syncthreads();
    src_v = cv;
    src_r = cr;
  }
  const int per = (n_lists + kWarps - 1) / kWarps;
  const int l0 = min(n_lists, warp * per);
  const int nl = min(n_lists, l0 + per) - l0;
  warp_merge(src_v + static_cast<size_t>(l0) * k,
             src_r + static_cast<size_t>(l0) * k, k, nl, k, lane,
             [&](int j, float v, int r) {
               wv[warp * k + j] = v;
               wrow[warp * k + j] = r;
             });
  __syncthreads();
  if (warp == 0)
    warp_merge(wv, wrow, k, kWarps, k, lane, [&](int j, float v, int r) {
      out_v[b * k + j] = v;
      out_r[b * k + j] = v > -INFINITY ? r : -1;
    });
}

constexpr size_t kMergeStageBytes = 160 * 1024;

template <class T>
cudaError_t launch_scan(int grid_x, cudaStream_t st, const float* q,
                        const float* corpus, const unsigned char* valid,
                        const int* row_group, const int* q_group,
                        float* cand_v, int* cand_r, int B, int N, int d,
                        int k) {
  const size_t smem = scan_smem_bytes<T>(k);
  auto kernel = topk_scan_kernel<T>;
  const cudaError_t err = has_kernels::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_x, (B + T::QB - 1) / T::QB);
  kernel<<<grid, kThreads, smem, st>>>(q, corpus, valid, row_group, q_group,
                                       cand_v, cand_r, B, N, d, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,d], corpus [N,d] f32 (d % 4 == 0, 16-byte aligned), valid [N]
// uint8; row_group [N] and q_group [B] both null or both set.  tile picks
// the query tile: 0 -> 1 query x 256 rows, 1 -> 8 x 256, 2 -> 64 x 128
// (k <= 64 there).  cand_v/cand_r [B, grid_x*k] scratch; out_v/out_r
// [B, k].  Two launches: the scan, then the merge.
int has_topk_search(const float* q, const float* corpus,
                    const unsigned char* valid, const int* row_group,
                    const int* q_group, float* cand_v, int* cand_r,
                    float* out_v, int* out_r, int B, int N, int d, int k,
                    int tile, int grid_x, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid_x < 1 || grid_x > 32 * kWarps || d % 4 != 0 ||
      (tile == 2 && k > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (tile == 0)
    err = launch_scan<Tile0>(grid_x, st, q, corpus, valid, row_group,
                               q_group, cand_v, cand_r, B, N, d, k);
  else if (tile == 1)
    err = launch_scan<Tile1>(grid_x, st, q, corpus, valid, row_group,
                               q_group, cand_v, cand_r, B, N, d, k);
  else if (tile == 2)
    err = launch_scan<Tile2>(grid_x, st, q, corpus, valid, row_group,
                               q_group, cand_v, cand_r, B, N, d, k);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t lists = static_cast<size_t>(kWarps) * k * 8;
  const size_t cands = static_cast<size_t>(grid_x) * k * 8;
  const int stage = lists + cands <= kMergeStageBytes;
  const size_t smem = lists + (stage ? cands : 0);
  err = has_kernels::allow_smem(topk_block_merge_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_block_merge_kernel<<<B, kThreads, smem, st>>>(cand_v, cand_r, grid_x,
                                                     k, stage, out_v, out_r);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) of the scan for a query tile and k (for
// reports).
int has_topk_search_smem(int tile, int k) {
  if (tile == 0) return static_cast<int>(scan_smem_bytes<Tile0>(k));
  if (tile == 1) return static_cast<int>(scan_smem_bytes<Tile1>(k));
  return tile == 2 ? static_cast<int>(scan_smem_bytes<Tile2>(k)) : -1;
}

}  // extern "C"
