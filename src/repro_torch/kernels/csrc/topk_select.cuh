// Top-k selection and merging shared by the kernels that keep a top-k per
// block: warp_topk, warp_sort32_topk and warp_select_topk (select from
// scores in shared memory), warp_merge (merge sorted lists by their heads)
// and arrive (the last CTA of a group, by an atomic ticket;
// decode_attention.cu uses it too).
//
// On the TPU a kernel carries one running top-k across sequential grid
// steps.  Blocks on Hopper run in parallel and share nothing, so each block
// keeps its own sorted top-k and the lists are merged by their heads:
// topk_search.cu in a second kernel, ivf_scan.cu in the same launch by the
// last CTA of each query to arrive.
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

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float va, int ka, float vb, int kb) {
  return va > vb || (va == vb && ka < kb);
}

// The order of a score as an unsigned int: larger score, larger bits
// (-0 counts as +0, as the float compare does).
__device__ __forceinline__ unsigned order_bits(float v) {
  const unsigned u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A score back from its order bits.
__device__ __forceinline__ float from_order_bits(unsigned h) {
  return __uint_as_float(h & 0x80000000u ? h & 0x7fffffffu : ~h);
}

// One warp selects the k best of vals[0..n) in shared memory, ordered by
// (vals desc, key asc) with keys[i] >= 0 distinct.  A pick is two warp
// max reductions (redux.sync): the score's order bits, then ~key among
// the lanes that hold that score.  Taken entries are overwritten with
// -inf.  emit(j, val, key) is called by lane 0 for j = 0..k-1 (val =
// -inf and key = -1 once no finite score is left).
template <class Emit>
__device__ void warp_topk(float* vals, const int* keys, int n, int k,
                          int lane, Emit emit) {
  const unsigned empty = order_bits(-INFINITY);
  for (int j = 0; j < k; ++j) {
    unsigned bh = empty, bl = 0;
    int bp = -1;
    for (int i = lane; i < n; i += 32) {
      const unsigned h = order_bits(vals[i]);
      const unsigned l = ~static_cast<unsigned>(keys[i]);
      if (h > bh || (h == bh && h > empty && l > bl)) {
        bh = h;
        bl = l;
        bp = i;
      }
    }
    const unsigned wh = __reduce_max_sync(kFull, bh);
    const unsigned wl = __reduce_max_sync(kFull, bh == wh ? bl : 0u);
    if (wh == empty) {                    // nothing finite is left
      if (lane == 0)
        for (; j < k; ++j) emit(j, -INFINITY, -1);
      break;
    }
    if (lane == 0) emit(j, from_order_bits(wh), static_cast<int>(~wl));
    if (bh == wh && bl == wl) vals[bp] = -INFINITY;
    __syncwarp();
  }
}

// One warp selects the k best of the n <= 32 entries vals/keys[0..n)
// (keys >= 0 distinct), ordered by (vals desc, key asc): a bitonic sort of
// one 64-bit (order bits, ~key) word a lane, by shuffles: 15 steps, which
// took less time than k picks by warp max reductions at k = 10.  The
// first k go to out_v/out_k (-inf and -1 past the finite entries).
__device__ inline void warp_sort32_topk(const float* vals, const int* keys,
                                        int n, int k, int lane, float* out_v,
                                        int* out_k) {
  unsigned long long x =
      lane < n ? (static_cast<unsigned long long>(order_bits(vals[lane]))
                      << 32 |
                  ~static_cast<unsigned>(keys[lane]))
               : 0ull;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, x, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      x = keep_max ? (o > x ? o : x) : (o < x ? o : x);
    }
  const unsigned h = static_cast<unsigned>(x >> 32);
  const bool finite = h > order_bits(-INFINITY);
  if (lane < k) {
    out_v[lane] = finite ? from_order_bits(h) : -INFINITY;
    out_k[lane] = finite ? static_cast<int>(~static_cast<unsigned>(x)) : -1;
  }
  for (int e = 32 + lane; e < k; e += 32) {
    out_v[e] = -INFINITY;
    out_k[e] = -1;
  }
}

// One warp selects the k best of the n <= 32*R entries vals/keys[0..n)
// (keys >= 0 distinct), ordered by (vals desc, key asc).  Each lane sorts
// its R entries, as 64-bit (order bits, ~key) words, in registers; a pick
// is two warp max reductions over the lanes' heads, and the lane that held
// the pick moves its list up.  The picks go to out_v/out_k (-inf and -1
// once no finite entry is left).
template <int R>
__device__ void warp_select_topk(const float* vals, const int* keys, int n,
                                 int k, int lane, float* out_v,
                                 int* out_k) {
  unsigned long long x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    x[r] = e < n ? (static_cast<unsigned long long>(order_bits(vals[e]))
                        << 32 |
                    ~static_cast<unsigned>(keys[e]))
                 : 0ull;
  }
#pragma unroll
  for (int i = 0; i < R - 1; ++i)
#pragma unroll
    for (int r = 0; r < R - 1 - i; ++r)
      if (x[r] < x[r + 1]) {
        const unsigned long long t = x[r];
        x[r] = x[r + 1];
        x[r + 1] = t;
      }
  const unsigned empty = order_bits(-INFINITY);
  int j = 0;
  for (; j < k; ++j) {
    const unsigned h = static_cast<unsigned>(x[0] >> 32);
    const unsigned l = static_cast<unsigned>(x[0]);
    const unsigned wh = __reduce_max_sync(kFull, h);
    if (wh <= empty) break;               // nothing finite is left
    const unsigned wl = __reduce_max_sync(kFull, h == wh ? l : 0u);
    if (lane == 0) {
      out_v[j] = from_order_bits(wh);
      out_k[j] = static_cast<int>(~wl);
    }
    if (h == wh && l == wl) {
#pragma unroll
      for (int r = 0; r < R - 1; ++r) x[r] = x[r + 1];
      x[R - 1] = 0ull;
    }
  }
  for (j += lane; j < k; j += 32) {
    out_v[j] = -INFINITY;
    out_k[j] = -1;
  }
}

// One warp merges n <= 32 sorted lists (list l: vals/rows + l * stride, k
// entries, -inf ends a list) by their heads; emit(j, v, row) on lane 0
// for j = 0..k-1, v = -inf once all are spent.
template <class Emit>
__device__ void warp_merge(const float* vals, const int* rows, int stride,
                           int n, int k, int lane, Emit emit) {
  const bool has = lane < n;
  const float* lv = vals + static_cast<size_t>(has ? lane : 0) * stride;
  const int* lr = rows + static_cast<size_t>(has ? lane : 0) * stride;
  int head = 0;
  float hv = has ? lv[0] : -INFINITY;
  int hr = hv > -INFINITY ? lr[0] : INT_MAX;
  for (int j = 0; j < k; ++j) {
    float bv = hv;
    int br = hr, bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int orr = __shfl_xor_sync(kFull, br, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (better(ov, orr, bv, br) || (ov == bv && orr == br && ol < bl)) {
        bv = ov;
        br = orr;
        bl = ol;
      }
    }
    if (lane == 0) emit(j, bv, br);
    if (lane == bl && bv > -INFINITY) {
      ++head;
      hv = head < k ? lv[head] : -INFINITY;
      hr = hv > -INFINITY ? lr[head] : INT_MAX;
    }
  }
}

// True in every thread of the CTA that arrives last at `ticket` out of
// `members` CTAs; that CTA resets the ticket to 0.  Every CTA's global
// writes before the call are visible to the last one after it.
__device__ inline bool arrive(int* ticket, int members, int* flag_s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(ticket, 1) == members - 1;
    if (last) atomicExch(ticket, 0);
    *flag_s = last;
  }
  __syncthreads();
  const bool last = *flag_s != 0;
  if (last) __threadfence();
  return last;
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
