// Streaming inner-product top-k over a corpus: the HaS cache channel.
//
// Replaces src/repro/kernels/topk_search.py::_topk_kernel (Pallas, TPU):
// q [B,d] @ corpus[N,d]^T with masks (valid rows, optional row_group ==
// q_group) and a running top-k carried across sequential corpus tiles.
//
// What bounds it on an H100: bytes.  Every corpus row is read once per
// group of kQB queries, B*N*d FMAs against N*d*4 bytes; at the main-path
// shape (B=1, N=50,000 ring slots, d=768, f32) that is 153.6 MB, about
// 46 us at 3.35 TB/s, while the 38 MFLOP are nothing.
//
// Design: pass 1 gives each block kRows corpus rows and kQB queries
// (queries staged in shared memory, one warp per row, lanes striding over
// d so a warp reads 128 contiguous bytes per step, f32 FMAs, shuffle
// reduction).  Scores of the block's rows land in shared memory, masked to
// -inf, and one warp per query selects that chunk's top-k.  Pass 2
// (topk_merge_kernel) reduces the [B, chunks*k] candidates.  Ties go to
// the lower row in both passes.  The scores are plain f32 FMAs in a fixed
// order: no tensor cores, no TF32.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 256;   // corpus rows per block
constexpr int kQB = kWarps;  // queries per block: one selecting warp each

__global__ void topk_chunk_kernel(const float* __restrict__ q,
                                  const float* __restrict__ corpus,
                                  const unsigned char* __restrict__ valid,
                                  const int* __restrict__ row_group,
                                  const int* __restrict__ q_group,
                                  float* __restrict__ cand_vals,
                                  int* __restrict__ cand_rows, int B, int N,
                                  int d, int k, int n_chunks) {
  extern __shared__ float smem[];
  float* qs = smem;              // [kQB][d]
  float* sc = smem + kQB * d;    // [kQB][kRows]
  const int chunk = blockIdx.x;
  const int b0 = blockIdx.y * kQB;
  const int nq = min(kQB, B - b0);
  const int row0 = chunk * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kQB * d; i += kThreads) {
    const int j = i / d;
    qs[i] = j < nq ? q[static_cast<size_t>(b0 + j) * d + (i - j * d)] : 0.f;
  }
  __syncthreads();

  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    float acc[kQB];
#pragma unroll
    for (int j = 0; j < kQB; ++j) acc[j] = 0.f;
    if (row < N) {
      const float* v = corpus + static_cast<size_t>(row) * d;
      for (int e = lane; e < d; e += 32) {
        const float x = v[e];
#pragma unroll
        for (int j = 0; j < kQB; ++j) acc[j] = fmaf(qs[j * d + e], x, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kQB; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (lane == 0) {
      const bool row_ok = row < N && valid[row] != 0;
#pragma unroll
      for (int j = 0; j < kQB; ++j) {
        bool ok = row_ok && j < nq;
        if (ok && row_group != nullptr) ok = row_group[row] == q_group[b0 + j];
        sc[j * kRows + r] = ok ? acc[j] : -INFINITY;
      }
    }
  }
  __syncthreads();

  if (warp < nq) {
    const size_t base = static_cast<size_t>(b0 + warp) * n_chunks * k +
                        static_cast<size_t>(chunk) * k;
    has_kernels::warp_topk(sc + warp * kRows, nullptr, kRows, k, lane,
                           [&](int j, float v, int pos) {
                             cand_vals[base + j] = v;
                             cand_rows[base + j] = pos < 0 ? -1 : row0 + pos;
                           });
  }
}

}  // namespace

extern "C" {

int has_topk_rows_per_block() { return kRows; }

// Pass 1: cand_vals/cand_rows are [B, n_chunks*k], n_chunks = ceil(N/kRows).
// row_group and q_group are both null or both set.
int has_topk_search(const float* q, const float* corpus,
                    const unsigned char* valid, const int* row_group,
                    const int* q_group, float* cand_vals, int* cand_rows,
                    int B, int N, int d, int k, int n_chunks, void* stream) {
  const size_t smem = static_cast<size_t>(kQB) * (d + kRows) * sizeof(float);
  cudaError_t err = has_kernels::allow_smem(topk_chunk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_chunks, (B + kQB - 1) / kQB);
  topk_chunk_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      q, corpus, valid, row_group, q_group, cand_vals, cand_rows, B, N, d, k,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: [rows, m] candidates -> [rows, k] (shared with ivf_scan.cu).
int has_topk_merge(const float* in_vals, const int* in_keys,
                   const int* in_pay, int rows, int m, int k, float* out_vals,
                   int* out_keys, int* out_pay, void* stream) {
  return has_kernels::launch_topk_merge(in_vals, in_keys, in_pay, rows, m, k,
                                        out_vals, out_keys, out_pay,
                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
