// Hashed-term lexical scoring with the reference's streamed top-k.
//
// Replaces src/repro/kernels/lexical_score.py::_lexical_kernel (Pallas,
// TPU).  A doc scores s = sum_t qw[t] * sum_l dw[l]*[dt[l] == qt[t]] (-1
// terms inert; no positive mass -> -inf, id -1), summed over l, then t, in
// order with rounded, uncontracted adds and multiplies, so the scores are
// bit-equal to the plain version's.
//
// On the TPU one grid walks the postings tiles in order and merges each
// tile into a running [k] buffer: K rounds of "the tile's best replaces
// the buffer's argmin (its lowest slot among equal minima) when strictly
// greater", then a stable sort.  The answer depends on the tile boundaries
// and on that exchange (it is not the exact top-k by score, then row:
// lexical scores tie all the time), so it is replayed here:
//
//   pass 1 (lexical_tile_kernel): one block per tile_n-row tile, over every
//     query; each writes its tile's top-k in the order of the reference's
//     rounds (score desc, column asc), finite ones only, and their count;
//   pass 2 (lexical_merge_kernel): one block per query compacts the finite
//     candidates of 256 tiles at a time into shared memory, in tile order,
//     and warp 0 replays the exchange on a buffer held one slot per lane
//     (k <= 32); a candidate not greater than the buffer's minimum changes
//     nothing, so -inf candidates are never stored.  Last, a stable sort by
//     value desc over slot order; ids of -inf slots become -1.
//
// What bounds it on an H100: bytes at B=1 (the postings stream, N*L*8
// bytes: 20 MB at N=500,000, L=5, about 6 us at 3.35 TB/s); 32-bit integer
// compares and adds at larger B (B*N*T*L of each).  Each tile is read once
// into shared memory and scored for every query from there.
#include <cuda_runtime.h>
#include <math.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void lexical_tile_kernel(const int* __restrict__ q_terms,
                                    const float* __restrict__ q_weights,
                                    const int* __restrict__ doc_terms,
                                    const float* __restrict__ doc_weights,
                                    float* __restrict__ cand_vals,
                                    int* __restrict__ cand_rows,
                                    int* __restrict__ counts, int B, int T,
                                    int N, int L, int tile_n, int k) {
  extern __shared__ int lsmem[];
  int* s_t = lsmem;                                             // [tile_n*L]
  float* s_w = reinterpret_cast<float*>(lsmem + tile_n * L);    // [tile_n*L]
  float* sc = s_w + tile_n * L;                                 // [tile_n]
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const size_t row0 = static_cast<size_t>(tile) * tile_n;
  // rows past N are the reference's pad rows: -1 terms, never finite
  const long long left =
      static_cast<long long>(N) - static_cast<long long>(row0);
  const int rows = left < tile_n ? static_cast<int>(left) : tile_n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < rows * L; i += kThreads) {
    s_t[i] = doc_terms[row0 * L + i];
    s_w[i] = doc_weights[row0 * L + i];
  }
  __syncthreads();

  for (int b = 0; b < B; ++b) {
    bool any = false;
    for (int r = threadIdx.x; r < tile_n; r += kThreads) {
      float s = -INFINITY;
      if (r < rows) {
        float acc = 0.f;
        for (int t = 0; t < T; ++t) {
          const int qt = q_terms[static_cast<size_t>(b) * T + t];
          const float qw = q_weights[static_cast<size_t>(b) * T + t];
          float m = 0.f;
          for (int l = 0; l < L; ++l) {
            const int dt = s_t[r * L + l];
            m = __fadd_rn(m, (dt == qt && dt >= 0 && qt >= 0) ? s_w[r * L + l]
                                                              : 0.f);
          }
          acc = __fadd_rn(acc, __fmul_rn(qw, m));
        }
        if (acc > 0.f) s = acc;
      }
      sc[r] = s;
      any |= s > -INFINITY;
    }
    const size_t cell = static_cast<size_t>(b) * n_tiles + tile;
    if (__syncthreads_count(any) == 0) {
      if (threadIdx.x == 0) counts[cell] = 0;
    } else if (warp == 0) {
      // the reference's rounds: best (score desc, column asc), then remove
      int j = 0;
      for (; j < k; ++j) {
        float bv = -INFINITY;
        int bk = INT_MAX;
        for (int i = lane; i < tile_n; i += 32) {
          if (has_kernels::better(sc[i], i, bv, bk)) { bv = sc[i]; bk = i; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
          if (has_kernels::better(ov, ok, bv, bk)) { bv = ov; bk = ok; }
        }
        if (!(bv > -INFINITY)) break;          // the tile has no more
        if (lane == 0) {
          cand_vals[cell * k + j] = bv;
          cand_rows[cell * k + j] = static_cast<int>(row0) + bk;
          sc[bk] = -INFINITY;
        }
        __syncwarp();
      }
      if (lane == 0) counts[cell] = j;
    }
    __syncthreads();                           // sc is reused for b + 1
  }
}

// Exclusive prefix sum of x over the block; *total gets the sum.
__device__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[w];
      warp_tot[w] = run;
      run += t;
    }
    *total = run;
  }
  __syncthreads();
  return warp_tot[warp] + incl - x;
}

__global__ void lexical_merge_kernel(const float* __restrict__ cand_vals,
                                     const int* __restrict__ cand_rows,
                                     const int* __restrict__ counts,
                                     float* __restrict__ out_vals,
                                     int* __restrict__ out_ids, int n_tiles,
                                     int k) {
  extern __shared__ float msmem[];
  float* s_v = msmem;                                         // [256*k]
  int* s_r = reinterpret_cast<int*>(msmem + kThreads * k);    // [256*k]
  __shared__ int warp_tot[kWarps];
  __shared__ int total;
  const size_t b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the running buffer: slot `lane` for lanes < k (warp 0 only)
  float bv = -INFINITY;
  int bi = -1;
  float mn = -INFINITY;    // the buffer's minimum and its lowest slot
  int mslot = 0;

  for (int base = 0; base < n_tiles; base += kThreads) {
    const int t = base + threadIdx.x;
    const size_t cell = b * n_tiles + t;
    const int c = t < n_tiles ? counts[cell] : 0;
    const int off = block_exclusive_scan(c, warp_tot, &total);
    for (int j = 0; j < c; ++j) {
      s_v[off + j] = cand_vals[cell * k + j];
      s_r[off + j] = cand_rows[cell * k + j];
    }
    __syncthreads();
    if (warp == 0) {
      for (int i = 0; i < total; ++i) {
        const float v = s_v[i];
        if (!(v > mn)) continue;             // not strictly greater: no-op
        if (lane == mslot) { bv = v; bi = s_r[i]; }
        float mv = lane < k ? bv : INFINITY;
        int ms = lane;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, mv, o);
          const int os = __shfl_xor_sync(0xffffffffu, ms, o);
          if (ov < mv || (ov == mv && os < ms)) { mv = ov; ms = os; }
        }
        mn = mv;
        mslot = ms;
      }
    }
    __syncthreads();                           // s_v, s_r, warp_tot reused
  }

  if (warp == 0) {
    // stable sort by value desc over slot order
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const float vi = __shfl_sync(0xffffffffu, bv, i);
      rank += (vi > bv || (vi == bv && i < lane)) ? 1 : 0;
    }
    if (lane < k) {
      out_vals[b * k + rank] = bv;
      out_ids[b * k + rank] = bv > -INFINITY ? bi : -1;
    }
  }
}

}  // namespace

extern "C" {

// Pass 1: cand_vals / cand_rows [B, n_tiles, k], counts [B, n_tiles].
int has_lexical_tiles(const int* q_terms, const float* q_weights,
                      const int* doc_terms, const float* doc_weights,
                      float* cand_vals, int* cand_rows, int* counts, int B,
                      int T, int N, int L, int tile_n, int k, void* stream) {
  const int n_tiles = (N + tile_n - 1) / tile_n;
  const size_t smem = static_cast<size_t>(tile_n) * (2 * L + 1) * 4;
  cudaError_t err = has_kernels::allow_smem(lexical_tile_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lexical_tile_kernel<<<n_tiles, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      q_terms, q_weights, doc_terms, doc_weights, cand_vals, cand_rows,
      counts, B, T, N, L, tile_n, k);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: out_vals / out_ids [B, k], k <= 32.
int has_lexical_merge(const float* cand_vals, const int* cand_rows,
                      const int* counts, float* out_vals, int* out_ids, int B,
                      int n_tiles, int k, void* stream) {
  const size_t smem = static_cast<size_t>(kThreads) * k * 8;
  cudaError_t err = has_kernels::allow_smem(lexical_merge_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lexical_merge_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      cand_vals, cand_rows, counts, out_vals, out_ids, n_tiles, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
