// Fixed-arity EmbeddingBag: out[b] = sum_j table[ids[b, j]] * w[b, j] * scale.
//
// Replaces src/repro/kernels/embedding_bag.py::_bag_kernel (Pallas, TPU).
// table [V, d] (f32 or bf16), ids [B, n] int32 or int64 in [0, V), weights
// [B, n] f32 or null (1.0), scale 1 ("sum") or 1/n ("mean"); out [B, d] in
// the table's type.
//
// What bounds it on an H100: at the Criteo shapes (B=512, 26-39 fields,
// d=10-64) the bytes are the B*n gathered rows, 0.8-3.4 MB, well under a
// microsecond at 3.35 TB/s; so the time is latency: the ids, then the rows
// they name, two dependent DRAM round trips, and the launch.  On an H100
// (kernels/embedding_bag_probe.py, L2 warm) the launch alone is ~0.9 us,
// the ids ~0.6, the rows 0.7 (deepfm) to 1.3 us (dlrm-rm2), the sum 0.6
// (deepfm) to 0.3 us (dlrm-rm2).
//
// Design: one warp per (bag, block of up to 128 columns), four warps to a
// CTA (B=512 at d <= 128 is 128 CTAs, about one per SM).  The warp loads
// the bag's ids in one coalesced load (int32 or int64, no cast launch),
// then issues every row gather of the bag at once into its shared memory,
// with cp.async of the widest size that the row's byte width and the
// table's alignment allow (16 bytes for dlrm-rm2's 256-byte rows, 8 for
// deepfm's 40-byte rows, 4 otherwise; 2-byte loads for a bf16 table of odd
// d), and waits once.  A bag longer than the warp's shared memory takes
// several such passes.  Then each lane sums its columns over j = 0..n-1 in
// slot order, (row * w) * scale added with rounded, uncontracted
// operations (__fmul_rn, __fadd_rn), as the TPU kernel adds each slot into
// its output block; for a bf16 table the term and the sum are rounded to
// bf16 after every add, as the TPU's bf16 output block is.  So the result
// is bit-equal to the sequential plain version.  A lane keeps only the
// accumulators its block needs (NA: 1 for d <= 32, 2 for d <= 64, else 4)
// and reads eight slots' values before it adds them, so the sum waits on
// shared memory once per eight slots.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                   // (bag, column block)s per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kColBlock = 128;              // columns a warp sums
constexpr int kAhead = 8;                   // slots read before they are added
constexpr int kWarpSmem = 12 * 1024;        // shared memory of one warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Copy W bytes from global to shared memory: cp.async for 16, 8 and 4
// (both addresses W-aligned), a 2-byte load and store for W = 2.
template <int W>
__device__ __forceinline__ void copy(unsigned char* dst,
                                     const unsigned char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else if constexpr (W == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else if constexpr (W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  }
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// One warp's shared memory for passes of `slots` slots of `sub` bytes:
// the rows, then each slot's source address and weight; a multiple of 16
// bytes, so that every warp's rows take 16-byte copies.
__host__ __device__ constexpr int warp_bytes(int slots, int sub) {
  return round16(slots * sub) + round16(slots * 8) + round16(slots * 4);
}

// The term of slot value x (weight w) added to acc, in the plain order.
template <typename T>
__device__ __forceinline__ float add_slot(float acc, float x, float w,
                                          float scale) {
  return add_term(acc, __fmul_rn(__fmul_rn(x, w), scale),
                  static_cast<T*>(nullptr));
}

template <typename T, typename Id, int W, int NA>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, const Id* __restrict__ ids,
           const float* __restrict__ weights, T* __restrict__ out, int B,
           int n, int d, int slots, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_cb = (d + kColBlock - 1) / kColBlock;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(B) * n_cb) return;
  const int b = static_cast<int>(task / n_cb);
  const int c0 = static_cast<int>(task - static_cast<long long>(b) * n_cb) *
                 kColBlock;
  const int cols = min(kColBlock, d - c0);
  const int sub = cols * static_cast<int>(sizeof(T));   // bytes a slot
  const int max_sub = min(d, kColBlock) * static_cast<int>(sizeof(T));
  unsigned char* rows = smem + warp * warp_bytes(slots, max_sub);
  const unsigned char** src = reinterpret_cast<const unsigned char**>(
      rows + round16(slots * max_sub));
  float* w_s = reinterpret_cast<float*>(src + slots);
  const size_t row_bytes = static_cast<size_t>(d) * sizeof(T);
  const unsigned char* tab = reinterpret_cast<const unsigned char*>(table) +
                             static_cast<size_t>(c0) * sizeof(T);
  const Id* bag = ids + static_cast<size_t>(b) * n;
  const float* bw = weights ? weights + static_cast<size_t>(b) * n : nullptr;
  const int chunks = sub / W;                  // W-byte copies a slot

  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  for (int j0 = 0; j0 < n; j0 += slots) {
    const int m = min(slots, n - j0);
    for (int j = lane; j < m; j += 32) {
      src[j] = tab + static_cast<size_t>(bag[j0 + j]) * row_bytes;
      w_s[j] = bw ? bw[j0 + j] : 1.0f;
    }
    __syncwarp();
    // every gather of the pass in flight at once
    for (int i = lane; i < m * chunks; i += 32) {
      const int j = i / chunks;
      const int c = i - j * chunks;
      copy<W>(rows + j * sub + c * W, src[j] + c * W);
    }
    if constexpr (W != 2) asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
    const T* r = reinterpret_cast<const T*>(rows);
    int j = 0;
    for (; j + kAhead <= m; j += kAhead) {
      float x[kAhead][NA], w[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        w[u] = w_s[j + u];
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const int c = lane + 32 * a;
          x[u][a] = c < cols ? to_f32(r[(j + u) * cols + c]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int a = 0; a < NA; ++a)
          acc[a] = add_slot<T>(acc[a], x[u][a], w[u], scale);
    }
    for (; j < m; ++j) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int c = lane + 32 * a;
        if (c < cols)
          acc[a] = add_slot<T>(acc[a], to_f32(r[j * cols + c]), w_s[j],
                               scale);
      }
    }
    __syncwarp();                               // the next pass reuses rows
  }
  T* o = out + static_cast<size_t>(b) * d + c0;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int c = lane + 32 * a;
    if (c < cols) store(o + c, acc[a]);
  }
}

// bag_kernel<T, Id, W, NA> with the accumulators that d's blocks need.
template <typename T, typename Id, int W>
void go(unsigned blocks, int smem, cudaStream_t st, const T* t, const Id* i,
        const float* weights, T* o, int B, int n, int d, int slots,
        float scale) {
  if (d <= 32)
    bag_kernel<T, Id, W, 1><<<blocks, kThreads, smem, st>>>(
        t, i, weights, o, B, n, d, slots, scale);
  else if (d <= 64)
    bag_kernel<T, Id, W, 2><<<blocks, kThreads, smem, st>>>(
        t, i, weights, o, B, n, d, slots, scale);
  else
    bag_kernel<T, Id, W, kColBlock / 32><<<blocks, kThreads, smem, st>>>(
        t, i, weights, o, B, n, d, slots, scale);
}

template <typename T, typename Id>
cudaError_t launch(const void* table, const void* ids, const float* weights,
                   void* out, int B, int n, int d, float scale,
                   cudaStream_t st) {
  const int elem = static_cast<int>(sizeof(T));
  const size_t row_bytes = static_cast<size_t>(d) * elem;
  const uintptr_t base = reinterpret_cast<uintptr_t>(table);
  const int max_sub = (d < kColBlock ? d : kColBlock) * elem;
  int slots = (kWarpSmem - 48) / (max_sub + 12);   // warp_bytes <= kWarpSmem
  slots = slots < 1 ? 1 : (slots > n ? (n > 0 ? n : 1) : slots);
  const int smem = kWarps * warp_bytes(slots, max_sub);
  const long long tasks =
      static_cast<long long>(B) * ((d + kColBlock - 1) / kColBlock);
  const unsigned blocks = static_cast<unsigned>((tasks + kWarps - 1) /
                                                kWarps);
  const T* t = static_cast<const T*>(table);
  const Id* i = static_cast<const Id*>(ids);
  T* o = static_cast<T*>(out);
  // the widest copy that every row start and column block start allows
  // (a column block is 128 columns: a multiple of 16 bytes)
  if (row_bytes % 16 == 0 && base % 16 == 0)
    go<T, Id, 16>(blocks, smem, st, t, i, weights, o, B, n, d, slots, scale);
  else if (row_bytes % 8 == 0 && base % 8 == 0)
    go<T, Id, 8>(blocks, smem, st, t, i, weights, o, B, n, d, slots, scale);
  else if (row_bytes % 4 == 0 && base % 4 == 0)
    go<T, Id, 4>(blocks, smem, st, t, i, weights, o, B, n, d, slots, scale);
  else
    go<T, Id, 2>(blocks, smem, st, t, i, weights, o, B, n, d, slots, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [V,d] (bf16 if is_bf16, else f32), ids [B,n] (int64 if ids64,
// else int32), weights [B,n] f32 or null, out [B,d] of the table's type.
int has_embedding_bag(const void* table, const void* ids,
                      const float* weights, void* out, int B, int n, int d,
                      float scale, int is_bf16, int ids64, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = ids64 ? launch<__nv_bfloat16, long long>(table, ids, weights, out,
                                                   B, n, d, scale, st)
                : launch<__nv_bfloat16, int>(table, ids, weights, out, B, n,
                                             d, scale, st);
  else
    err = ids64 ? launch<float, long long>(table, ids, weights, out, B, n, d,
                                           scale, st)
                : launch<float, int>(table, ids, weights, out, B, n, d,
                                     scale, st);
  return static_cast<int>(err);
}

}  // extern "C"
