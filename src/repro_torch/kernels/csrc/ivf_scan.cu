// IVF probed-bucket scan (f32 buckets): the HaS fuzzy channel.
//
// Replaces src/repro/kernels/ivf_scan.py::_ivf_kernel (Pallas, TPU): per
// (query b, probe p) the [cap,d] bucket probe[b,p] is scored against q[b],
// pad slots (id < 0) are masked, and the global ids fold into a running
// top-k.  On the TPU the probe table is scalar-prefetched so the BlockSpec
// can DMA the chosen bucket; here each block reads its own probe[b,p].
// The int8 residual mode (_ivf_kernel_scaled) is not ported yet.
//
// What bounds it on an H100: bytes.  Each probed bucket is read once per
// query: B*P*cap*d*4 bytes, about 24 MB at the main-path shape (B=1,
// P=64, cap=123, d=768), about 7 us at 3.35 TB/s.  At B=1 the grid is
// only 64 blocks, half the 132 SMs; that is accepted for now.
//
// Design: grid (P, B); 256 threads, one warp per bucket row, lanes
// striding over d (128 contiguous bytes per warp step), f32 FMAs and a
// shuffle reduction; scores land in shared memory and warp 0 selects the
// bucket's top-k with tie key p*cap + slot (the flat position the
// reference's lax.top_k breaks ties on).  Pass 2 is topk_merge_kernel
// over [B, P*k], the same merge as topk_search.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void ivf_bucket_kernel(const float* __restrict__ q,
                                  const int* __restrict__ probe,
                                  const float* __restrict__ bucket_vecs,
                                  const int* __restrict__ bucket_ids,
                                  float* __restrict__ cand_vals,
                                  int* __restrict__ cand_keys,
                                  int* __restrict__ cand_ids, int P, int C,
                                  int cap, int d, int k) {
  extern __shared__ float smem[];
  float* qs = smem;        // [d]
  float* sc = smem + d;    // [cap]
  const int p = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // an out-of-range probe is clamped, as the reference's gather clamps
  const int c = min(max(probe[static_cast<size_t>(b) * P + p], 0), C - 1);
  const float* vecs = bucket_vecs + static_cast<size_t>(c) * cap * d;
  const int* ids = bucket_ids + static_cast<size_t>(c) * cap;

  for (int i = threadIdx.x; i < d; i += kThreads)
    qs[i] = q[static_cast<size_t>(b) * d + i];
  __syncthreads();

  for (int r = warp; r < cap; r += kWarps) {
    const float* v = vecs + static_cast<size_t>(r) * d;
    float acc = 0.f;
    for (int e = lane; e < d; e += 32) acc = fmaf(qs[e], v[e], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sc[r] = ids[r] >= 0 ? acc : -INFINITY;
  }
  __syncthreads();

  if (warp == 0) {
    const size_t base = (static_cast<size_t>(b) * P + p) * k;
    has_kernels::warp_topk(sc, nullptr, cap, k, lane,
                           [&](int j, float v, int pos) {
                             cand_vals[base + j] = v;
                             cand_keys[base + j] = pos < 0 ? -1 : p * cap + pos;
                             cand_ids[base + j] = pos < 0 ? -1 : ids[pos];
                           });
  }
}

}  // namespace

extern "C" {

// Pass 1: cand_* are [B, P*k].
int has_ivf_scan(const float* q, const int* probe, const float* bucket_vecs,
                 const int* bucket_ids, float* cand_vals, int* cand_keys,
                 int* cand_ids, int B, int P, int C, int cap, int d, int k,
                 void* stream) {
  const size_t smem = static_cast<size_t>(d + cap) * sizeof(float);
  cudaError_t err = has_kernels::allow_smem(ivf_bucket_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P, B);
  ivf_bucket_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      q, probe, bucket_vecs, bucket_ids, cand_vals, cand_keys, cand_ids, P, C,
      cap, d, k);
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
