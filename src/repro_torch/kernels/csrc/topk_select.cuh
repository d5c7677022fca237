// Warp-level top-k selection and the candidate merge of ivf_scan.cu; the
// order key below is shared with topk_search.cu (which has its own merge).
//
// On the TPU the kernel carries one running top-k across sequential grid
// steps.  Blocks on Hopper run in parallel and share nothing, so
// ivf_scan.cu works in two passes: pass 1 writes a top-k per (query,
// probed bucket); pass 2 (topk_merge_kernel below) reduces each query's
// candidates to its final top-k.
//
// Order key everywhere: score descending, then a tie key ascending (the
// lower corpus row, or the earlier flat probe position), the rule of
// lax.top_k in the reference.  An entry whose best remaining score is -inf
// is empty and comes out as (-inf, key -1, payload -1).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace has_kernels {

__device__ __forceinline__ bool better(float va, int ka, float vb, int kb) {
  return va > vb || (va == vb && ka < kb);
}

// One warp selects the k best of vals[0..n) in shared memory, ordered by
// (vals desc, key asc) with key = keys[i], or i when keys is null.  Taken
// entries are overwritten with -inf.  Every lane returns the same picks;
// emit(j, val, pos) is called by lane 0 for j = 0..k-1 (pos = -1: empty).
template <class Emit>
__device__ void warp_topk(float* vals, const int* keys, int n, int k,
                          int lane, Emit emit) {
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bk = INT_MAX;
    int bp = -1;
    for (int i = lane; i < n; i += 32) {
      const float v = vals[i];
      const int key = keys ? keys[i] : i;
      if (better(v, key, bv, bk)) { bv = v; bk = key; bp = i; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (better(ov, ok, bv, bk)) { bv = ov; bk = ok; bp = op; }
    }
    const bool empty = !(bv > -INFINITY);
    if (lane == 0) {
      emit(j, empty ? -INFINITY : bv, empty ? -1 : bp);
      if (!empty) vals[bp] = -INFINITY;
    }
    __syncwarp();
  }
}

// Pass 2: one warp per row of [rows, m] candidates -> [rows, k].
// Dynamic shared memory: m floats (scores) + m ints (tie keys).
__global__ void topk_merge_kernel(const float* __restrict__ in_vals,
                                  const int* __restrict__ in_keys,
                                  const int* __restrict__ in_pay, int m,
                                  int k, float* __restrict__ out_vals,
                                  int* __restrict__ out_keys,
                                  int* __restrict__ out_pay) {
  extern __shared__ float merge_smem[];
  float* s_vals = merge_smem;
  int* s_keys = reinterpret_cast<int*>(merge_smem + m);
  const size_t row = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < m; i += 32) {
    s_vals[i] = in_vals[row * m + i];
    s_keys[i] = in_keys[row * m + i];
  }
  __syncwarp();
  warp_topk(s_vals, s_keys, m, k, lane, [&](int j, float v, int pos) {
    out_vals[row * k + j] = v;
    out_keys[row * k + j] = pos < 0 ? -1 : s_keys[pos];
    out_pay[row * k + j] = pos < 0 ? -1 : in_pay[row * m + pos];
  });
}

inline int launch_topk_merge(const float* in_vals, const int* in_keys,
                             const int* in_pay, int rows, int m, int k,
                             float* out_vals, int* out_keys, int* out_pay,
                             cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(m) * (sizeof(float) + sizeof(int));
  topk_merge_kernel<<<rows, 32, smem, stream>>>(
      in_vals, in_keys, in_pay, m, k, out_vals, out_keys, out_pay);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory above 48 KB has to be opted into per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace has_kernels
