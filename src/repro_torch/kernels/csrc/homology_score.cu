// Homology scores of draft id lists against the cached query table.
//
// Replaces src/repro/kernels/homology_score.py::_homology_kernel (Pallas,
// TPU): for draft b and cached row h, the fraction of the draft's ids >= 0
// found among the row's k ids (count / k), or with draft_weights the sum of
// the matched slots' weights.  Rows with valid[h] == 0, or with
// row_group[h] != q_group[b] when groups are given, score 0.
//
// What bounds it on an H100: neither bytes nor operations but the launch.
// At the main-path shape (B=1, H=5000, k=10) it reads the 200 KB id table
// once and does 500k int compares: well under a microsecond of either, so
// the few microseconds of a kernel launch dominate.
//
// Design: one thread per (b, h), 256 threads per block over h, blockIdx.y
// = b; the draft row (and its weights) is staged in shared memory and each
// thread does its k x k integer compares in registers.  The score is
// (float)count / (float)k with IEEE division, exactly as the reference
// computes it: at tau = 0.2 and k = 10, 2/10 == 0.2f and accept is the
// strict best > tau, so any other rounding would flip accept bits.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void homology_kernel(const int* __restrict__ draft,
                                const int* __restrict__ cache,
                                const unsigned char* __restrict__ valid,
                                const float* __restrict__ weights,
                                const int* __restrict__ row_group,
                                const int* __restrict__ q_group,
                                float* __restrict__ out, int H, int k) {
  extern __shared__ int hsmem[];
  int* s_draft = hsmem;                                        // [k]
  float* s_w = reinterpret_cast<float*>(hsmem + k);            // [k]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    s_draft[i] = draft[static_cast<size_t>(b) * k + i];
    s_w[i] = weights ? weights[static_cast<size_t>(b) * k + i] : 0.f;
  }
  __syncthreads();
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  bool ok = valid[h] != 0;
  if (ok && row_group != nullptr) ok = row_group[h] == q_group[b];
  float s = 0.f;
  if (ok) {
    const int* row = cache + static_cast<size_t>(h) * k;
    int count = 0;
    float mass = 0.f;
    for (int i = 0; i < k; ++i) {
      const int id = s_draft[i];
      if (id < 0) continue;
      bool hit = false;
      for (int j = 0; j < k; ++j) hit |= row[j] == id;
      if (hit) {
        ++count;
        mass += s_w[i];
      }
    }
    s = weights ? mass : static_cast<float>(count) / static_cast<float>(k);
  }
  out[static_cast<size_t>(b) * H + h] = s;
}

}  // namespace

extern "C" {

// out [B, H] f32; weights, row_group and q_group may be null (the two
// groups together).
int has_homology_score(const int* draft, const int* cache,
                       const unsigned char* valid, const float* weights,
                       const int* row_group, const int* q_group, float* out,
                       int B, int H, int k, void* stream) {
  const dim3 grid((H + kThreads - 1) / kThreads, B);
  const size_t smem = static_cast<size_t>(k) * (sizeof(int) + sizeof(float));
  homology_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      draft, cache, valid, weights, row_group, q_group, out, H, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
