// Fixed-arity EmbeddingBag: out[b] = sum_j table[ids[b, j]] * w[b, j] * scale.
//
// Replaces src/repro/kernels/embedding_bag.py::_bag_kernel (Pallas, TPU).
// table [V, d] (f32 or bf16), ids [B, n] int32 in [0, V), weights [B, n] f32
// or null (1.0), scale 1 ("sum") or 1/n ("mean"); out [B, d] in the table's
// type.
//
// What bounds it on an H100: at the Criteo shapes (B=512, 26-39 fields,
// d=10-64) the bytes are the B*n gathered rows, 0.8-3.4 MB, about a
// microsecond at 3.35 TB/s, so the launch dominates.
//
// Design: one thread per (bag, column), consecutive threads on consecutive
// columns so a row's gather is coalesced.  The thread walks the bag's slots
// in order j = 0..n-1 and adds (row * w) * scale into its sum with rounded,
// uncontracted operations (__fmul_rn, __fadd_rn), as the TPU kernel adds each
// slot into its output block.  For a bf16 table the term is rounded to bf16
// and the sum is rounded to bf16 after every add, as the TPU's bf16 output
// block is.  So the result is bit-equal to a sequential version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float add_term(float acc, float x, float*) {
  return __fadd_rn(acc, x);
}
__device__ __forceinline__ float add_term(float acc, float x,
                                          __nv_bfloat16*) {
  // acc holds a bf16 value; bf16 + bf16 is exact in f32 up to the rounding
  // back to bf16, so this is a correctly rounded bf16 add
  const float xb = __bfloat162float(__float2bfloat16_rn(x));
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, xb)));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);                // exact: x is a bf16 value
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
           const float* __restrict__ weights, T* __restrict__ out, int B,
           int n, int d, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * d) return;
  const int b = static_cast<int>(i / d);
  const int col = static_cast<int>(i - static_cast<long long>(b) * d);
  const int* bag = ids + static_cast<size_t>(b) * n;
  const float* bw = weights ? weights + static_cast<size_t>(b) * n : nullptr;
  float acc = 0.f;
  for (int j = 0; j < n; ++j) {
    const float row = load_f32(table + static_cast<size_t>(bag[j]) * d + col);
    const float w = bw ? bw[j] : 1.0f;
    acc = add_term(acc, __fmul_rn(__fmul_rn(row, w), scale),
                   static_cast<T*>(nullptr));
  }
  store(out + i, acc);
}

}  // namespace

extern "C" {

// table [V,d] (bf16 if is_bf16, else f32), ids [B,n] int32, weights [B,n]
// f32 or null, out [B,d] of the table's type.
int has_embedding_bag(const void* table, const int* ids, const float* weights,
                      void* out, int B, int n, int d, float scale,
                      int is_bf16, void* stream) {
  const long long total = static_cast<long long>(B) * d;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) /
                                                kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    bag_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), ids, weights,
        static_cast<__nv_bfloat16*>(out), B, n, d, scale);
  else
    bag_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(table), ids, weights,
        static_cast<float*>(out), B, n, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
