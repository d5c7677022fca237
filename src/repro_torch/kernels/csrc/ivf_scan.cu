// IVF probed-bucket scan: f32 buckets (the HaS fuzzy channel) and int8
// centroid-residual codes (the compressed ANN cloud stage).
//
// Replaces src/repro/kernels/ivf_scan.py::_ivf_kernel and its scaled mode
// _ivf_kernel_scaled (Pallas, TPU): per (query b, probe p) the [cap,d]
// bucket probe[b,p] is scored against q[b], pad slots (id < 0) are masked,
// and the global ids fold into a running top-k.  On the TPU the probe
// table is scalar-prefetched so the BlockSpec can DMA the chosen bucket;
// here each block reads probe[b, p] for the rows it scores.
//
// What bounds it on an H100: bytes.  Each probed bucket's ids are read
// once per query, and the vectors of its valid slots (a pad is never
// read).  f32: B*P*cap*d*4 bytes with no pads, about 24 MB at the fuzzy
// channel's shape (B=1, P=64, cap=123, d=768), about 7 us at 3.35 TB/s.
// int8: B*P*cap*(d + 8 + 4) bytes (codes, two scales, the id), about
// 24.4 MB at the cloud stage's shape (B=1, P=32, cap=977, d=768), about
// 7.3 us.
//
// Design: one launch per call, grid (L, B), 256 threads.
// - A query's pool is the flat sequence of its P*cap probed slots;
//   position p*cap + slot is the tie key of the reference's lax.top_k.  The
//   wrapper cuts it into L <= 256 even, contiguous ranges (plan_ranges), one
//   CTA each; a range may span bucket boundaries (row r of the pool is slot
//   r % cap of bucket probe[b, r / cap], clamped as the reference's gather
//   clamps).  So a batch of one still puts a CTA or more on every SM,
//   whatever P and cap are.
// - A CTA scores its range in chunks of up to kChunk rows.  Phase A: each
//   thread takes a row, reads its probe, id (and, int8, its two scales and
//   the probe's bias) at once; a pad scores -inf there and is never read,
//   the valid rows are listed in shared memory.  At B=1 each warp's
//   loads then depend on nothing but the list, so the scan is a few DRAM
//   round trips, not a chain of them per row.
// - Phase B scores the listed rows with 16-byte loads, all of a row's in
//   flight before their FMAs: f32 two rows a warp (six float4 a lane per
//   row of 768); int8 (d % 32 == 0) four rows a warp, 8 lanes a row (six
//   16-byte chunks a lane), one sum per half, reduced inside the 8 lanes,
//   scored (dot_lo*s_lo + dot_hi*s_hi) + bias[b,p] with rounded,
//   uncontracted multiplies and adds in the reference's order.  Rows that
//   are not 16-byte routable fall to char4 (int8, d % 8 == 0) or one
//   element at a time.  int8 codes become floats by a byte permute and an
//   add (exact), not the quarter-rate conversion.  Warp 0 then folds the
//   chunk's scores into the CTA's running top-k, kept in shared memory:
//   up to 32 candidates (the chunk and the list so far) by a bitonic sort
//   across the warp, up to 128 sorted four to a lane in registers and
//   picked by their heads, more by k rounds of a warp max over shared
//   memory (a register list of 256 took registers enough to halve the
//   CTAs per SM at B=64).
// - Each CTA writes its sorted top-k (score, flat key) to scratch [B, L, k]
//   and arrives at its query's ticket.  The last CTA of the query merges
//   the L sorted lists by their heads (8 warps of up to 32 lists, then
//   warp 0 over the 8; the lists are first copied to shared memory where
//   they fit), looks each key's global id up in bucket_ids, writes the
//   [B, k] output and resets the ticket, so no second launch is needed.
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using has_kernels::warp_merge;
using has_kernels::warp_select_topk;
using has_kernels::warp_sort32_topk;
using has_kernels::warp_topk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;           // rows scored per pass of the buffer
// the merge copies a query's lists to shared memory up to this size
constexpr size_t kStageBytes = 64 * 1024;
// 16-byte loads in flight per lane and row: a row of 768 takes 6 float4
// (f32, 32 lanes) or 6 int4 of codes (int8, 8 lanes); the char4 route keeps
// 8 char4 a lane in flight
constexpr int kVecsF32 = 6;
constexpr int kVecsInt8 = 6;
constexpr int kUnrollInt8 = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp's (q_lo . v_lo, q_hi . v_hi) for a row of d int8 codes.
template <bool kVec>
__device__ __forceinline__ float2 row_dot_int8(
    const signed char* __restrict__ v, const float* qs, int d, int lane) {
  const int h = d / 2;
  float lo = 0.f, hi = 0.f;
  if (kVec) {
    const char4* v4 = reinterpret_cast<const char4*>(v);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const int n4 = d / 4;
    const int h4 = h / 4;
    for (int e0 = lane; e0 < n4; e0 += 32 * kUnrollInt8) {
      char4 x[kUnrollInt8];
#pragma unroll
      for (int u = 0; u < kUnrollInt8; ++u) {
        const int e = e0 + 32 * u;
        x[u] = e < n4 ? v4[e] : make_char4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnrollInt8; ++u) {
        const int e = e0 + 32 * u;
        if (e < n4) {
          const float4 y = q4[e];
          float t = e < h4 ? lo : hi;
          t = fmaf(y.x, static_cast<float>(x[u].x), t);
          t = fmaf(y.y, static_cast<float>(x[u].y), t);
          t = fmaf(y.z, static_cast<float>(x[u].z), t);
          t = fmaf(y.w, static_cast<float>(x[u].w), t);
          if (e < h4) lo = t; else hi = t;
        }
      }
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float x = static_cast<float>(v[e]);
      if (e < h) lo = fmaf(qs[e], x, lo); else hi = fmaf(qs[e], x, hi);
    }
  }
  return make_float2(warp_sum(lo), warp_sum(hi));
}

// Operands of one call.  vecs is [C,cap,d] f32, or int8 codes when scales
// ([C,cap,2]) and bias ([B,P]) are set.  Scratch: tickets [B] (zero between
// launches), then per query `stride` floats of lists (L lists of k) and as
// many keys; stride is a whole number of 128-byte lines, so no two queries'
// lists share one.
struct Scan {
  const float* q;
  const int* probe;
  const void* vecs;
  const float* scales;
  const float* bias;
  const int* ids;
  int* tickets;
  float* list_v;
  int* list_k;
  float* out_v;
  int* out_i;
  int P, C, cap, d, k, stride, stage;
};

// How a row is read (the wrapper's alignment and d decide):
// f32 float4 / scalar; int8 16-byte (8 lanes a row) / char4 / scalar.
enum Route { kF32Vec, kF32Scalar, kI8Wide, kI8Char4, kI8Scalar };

// The valid rows of a chunk, listed by phase A: the i-th valid row sits at
// chunk position pos[i], bucket row row[i]; int8 also keeps its two scales
// and the probe's bias.
struct Rows {
  int* pos;
  int* row;
  float* s_lo;
  float* s_hi;
  float* bias;
};

// Shared words after q: the scan's (a chunk's row lists, scores and keys,
// and the running top-k) or the merge's (8 warps' lists of k, and the L
// lists when staged), whichever is more; then the k final keys.
__host__ __device__ inline int region_words(int k, int L, bool scaled,
                                            int stage) {
  const int scan = (scaled ? 5 : 2) * kChunk + 2 * (kChunk + k) + 2 * k;
  const int merge = 2 * kWarps * k + (stage ? 2 * L * k : 0);
  return scan > merge ? scan : merge;
}

// Phase stamps for ivf_scan_probe.py, compiled in only with
// -DIVF_SCAN_TRACE: thread 0 of each CTA records %globaltimer at the end
// of each phase (kTraceMarks a CTA, for the first kTraceCtas CTAs).
constexpr int kTraceMarks = 11;
constexpr int kTraceCtas = 4096;
#ifdef IVF_SCAN_TRACE
__device__ unsigned long long g_trace[kTraceCtas * kTraceMarks];
__device__ __forceinline__ void trace(int mark) {
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && cta < kTraceCtas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[cta * kTraceMarks + mark] = t;
  }
}
#else
__device__ __forceinline__ void trace(int) {}
#endif

// The bucket of probe position p of query b, clamped into [0, C).
__device__ __forceinline__ int bucket_of(const Scan& a, int b, int p) {
  return min(max(a.probe[static_cast<size_t>(b) * a.P + p], 0), a.C - 1);
}

// f32: each warp scores two rows at a time, all of both rows' float4s in
// flight (6 a lane per row of 768) before their FMAs; q from shared memory.
template <bool kVec>
__device__ void score_f32(const Scan& a, const float* qs, const Rows& r,
                          int nv, float* sc, int warp, int lane) {
  const float* base = static_cast<const float*>(a.vecs);
  const int d = a.d;
  for (int j = 2 * warp; j < nv; j += 2 * kWarps) {
    const bool two = j + 1 < nv;
    const float* va = base + static_cast<size_t>(r.row[j]) * d;
    const float* vb = base + static_cast<size_t>(r.row[two ? j + 1 : j]) * d;
    float acc_a = 0.f, acc_b = 0.f;
    if (kVec) {
      const float4* a4 = reinterpret_cast<const float4*>(va);
      const float4* b4 = reinterpret_cast<const float4*>(vb);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      const int n4 = d / 4;
      for (int e0 = lane; e0 < n4; e0 += 32 * kVecsF32) {
        float4 xa[kVecsF32], xb[kVecsF32];
#pragma unroll
        for (int u = 0; u < kVecsF32; ++u) {
          const int e = e0 + 32 * u;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          xa[u] = e < n4 ? a4[e] : z;
          xb[u] = two && e < n4 ? b4[e] : z;
        }
#pragma unroll
        for (int u = 0; u < kVecsF32; ++u) {
          const int e = e0 + 32 * u;
          if (e < n4) {
            const float4 y = q4[e];
            acc_a = fmaf(y.x, xa[u].x, acc_a);
            acc_a = fmaf(y.y, xa[u].y, acc_a);
            acc_a = fmaf(y.z, xa[u].z, acc_a);
            acc_a = fmaf(y.w, xa[u].w, acc_a);
            acc_b = fmaf(y.x, xb[u].x, acc_b);
            acc_b = fmaf(y.y, xb[u].y, acc_b);
            acc_b = fmaf(y.z, xb[u].z, acc_b);
            acc_b = fmaf(y.w, xb[u].w, acc_b);
          }
        }
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        const float y = qs[e];
        acc_a = fmaf(y, va[e], acc_a);
        if (two) acc_b = fmaf(y, vb[e], acc_b);
      }
    }
    acc_a = warp_sum(acc_a);
    acc_b = warp_sum(acc_b);
    if (lane == 0) {
      sc[r.pos[j]] = acc_a;
      if (two) sc[r.pos[j + 1]] = acc_b;
    }
  }
}

// The reference's rounding of an int8 score: (lo*s_lo + hi*s_hi) + bias,
// every multiply and add rounded, none contracted.
__device__ __forceinline__ float int8_score(float lo, float hi, const Rows& r,
                                            int j) {
  return __fadd_rn(__fadd_rn(__fmul_rn(lo, r.s_lo[j]),
                             __fmul_rn(hi, r.s_hi[j])),
                   r.bias[j]);
}

// Byte i of u (a code + 128) as a float, exactly: 0x4B0000uu is the float
// 2^23 + uu.  A byte permute and an add instead of an int-to-float
// conversion, which runs at a quarter of the rate.
__device__ __forceinline__ float code(unsigned u, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 | i)),
                   8388736.f);
}

// One 4-byte word of int8 codes against 4 floats of q.
__device__ __forceinline__ float dot4(int w, float4 y, float t) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  t = fmaf(y.x, code(u, 0), t);
  t = fmaf(y.y, code(u, 1), t);
  t = fmaf(y.z, code(u, 2), t);
  return fmaf(y.w, code(u, 3), t);
}

// Where q[i] sits in shared memory.  The 16-byte int8 route reads q as
// float4 4e + s (word s of 16-byte chunk e), which lies at float4
// 4e + ((s + e/2) % 4): the 8 lanes of a row then hit all 32 banks.
template <Route kRoute>
__device__ __forceinline__ int q_slot(int i) {
  if constexpr (kRoute != kI8Wide) return i;
  const int e = i >> 4, s = (i >> 2) & 3;
  return (e << 4) + (((s + (e >> 1)) & 3) << 2) + (i & 3);
}

// int8, d % 32 == 0, 16-byte aligned rows: 8 lanes a row, four rows a warp
// at once; lane g of a row loads 16-byte chunks g, g+8, ... (6 at d = 768,
// all in flight), chunks below d/2 feeding lo.  q sits swizzled (q_slot)
// so the 8 lanes of a row read it without bank conflicts.  The two sums
// reduce by shuffles inside the 8 lanes.  (Eight rows a warp took more
// registers, and was slower at B=64.)
__device__ void score_int8_wide(const Scan& a, const float* qs, const Rows& r,
                                int nv, float* sc, int warp, int lane) {
  const signed char* base = static_cast<const signed char*>(a.vecs);
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  const int d = a.d, n16 = d / 16, h16 = d / 32;
  const int grp = lane >> 3, g = lane & 7;
  for (int j0 = 4 * warp; j0 < nv; j0 += 4 * kWarps) {
    const int j = j0 + grp;
    const bool has = j < nv;
    const int4* v16 = reinterpret_cast<const int4*>(
        base + static_cast<size_t>(r.row[has ? j : j0]) * d);
    float lo = 0.f, hi = 0.f;
    for (int e0 = g; e0 < n16; e0 += 8 * kVecsInt8) {
      int4 x[kVecsInt8];
#pragma unroll
      for (int u = 0; u < kVecsInt8; ++u) {
        const int e = e0 + 8 * u;
        x[u] = has && e < n16 ? v16[e] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kVecsInt8; ++u) {
        const int e = e0 + 8 * u;
        if (e < n16) {
          const float4* y = q4 + 4 * e;
          const int rot = e >> 1;
          float t = e < h16 ? lo : hi;
          t = dot4(x[u].x, y[rot & 3], t);
          t = dot4(x[u].y, y[(rot + 1) & 3], t);
          t = dot4(x[u].z, y[(rot + 2) & 3], t);
          t = dot4(x[u].w, y[(rot + 3) & 3], t);
          if (e < h16) lo = t; else hi = t;
        }
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if (has && g == 0) sc[r.pos[j]] = int8_score(lo, hi, r, j);
  }
}

// int8 rows that are not 16-byte routable: one warp a row, char4 (d % 8
// == 0, 4-byte aligned) or one code at a time.
template <bool kVec>
__device__ void score_int8_warp(const Scan& a, const float* qs, const Rows& r,
                                int nv, float* sc, int warp, int lane) {
  const signed char* base = static_cast<const signed char*>(a.vecs);
  for (int j = warp; j < nv; j += kWarps) {
    const float2 dots = row_dot_int8<kVec>(
        base + static_cast<size_t>(r.row[j]) * a.d, qs, a.d, lane);
    if (lane == 0) sc[r.pos[j]] = int8_score(dots.x, dots.y, r, j);
  }
}

// int8 kernels are held to 64 registers (4 CTAs per SM): at B=64 that
// took 296 us against 318 with no limit, at B=1 the same.  The f32 kernel
// keeps its registers: held to 3 or 4 CTAs per SM it was slower at B=1
// (14.0 and 14.5 against 13.1 us).  (ivf_scan_probe.py, on an H100.)
template <Route kRoute>
__global__ void __launch_bounds__(kThreads, kRoute >= kI8Wide ? 4 : 1)
ivf_range_kernel(const Scan a) {
  constexpr bool kScaled = kRoute >= kI8Wide;
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag_s, nv_s;
  const int k = a.k, d = a.d, cap = a.cap;
  float* qs = smem;                                   // [d], 16-byte rounded
  int* words = reinterpret_cast<int*>(qs + ((d + 3) & ~3));
  Rows rows{words, words + kChunk, nullptr, nullptr, nullptr};
  float* sc = reinterpret_cast<float*>(words + 2 * kChunk);
  if (kScaled) {
    rows.s_lo = sc;
    rows.s_hi = sc + kChunk;
    rows.bias = sc + 2 * kChunk;
    sc += 3 * kChunk;
  }
  int* sk = reinterpret_cast<int*>(sc + kChunk + k);  // [kChunk + k] keys
  float* lv = reinterpret_cast<float*>(sk + kChunk + k);  // running top-k
  int* lk = reinterpret_cast<int*>(lv + k);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, L = gridDim.x;
  const long long n = static_cast<long long>(a.P) * cap;
  const int r0 = static_cast<int>(n * blockIdx.x / L);
  const int r1 = static_cast<int>(n * (blockIdx.x + 1) / L);
  trace(0);

  for (int j = tid; j < k; j += kThreads) {
    lv[j] = -INFINITY;
    lk[j] = -1;
  }
  if (tid == 0) nv_s = 0;
  __syncthreads();
  trace(1);
  // q lands in shared memory while phase A's loads are in flight
  for (int i = tid; i < d; i += kThreads)
    qs[q_slot<kRoute>(i)] = a.q[static_cast<size_t>(b) * d + i];

  for (int c0 = r0; c0 < r1; c0 += kChunk) {
    const int m = min(kChunk, r1 - c0);
    // phase A: every thread a row: its bucket row and id; pads score -inf
    // here, the valid rows (and their scales and bias) are listed
    for (int i0 = warp * 32; i0 < m; i0 += kThreads) {
      const int i = i0 + lane, f = c0 + i;
      const int p = f / cap;
      int row = 0;
      bool valid = false;
      float s_lo = 0.f, s_hi = 0.f, bias = 0.f;
      if (i < m) {
        row = bucket_of(a, b, p) * cap + (f - p * cap);
        if constexpr (kScaled) {        // in flight beside the id
          s_lo = a.scales[2 * static_cast<size_t>(row)];
          s_hi = a.scales[2 * static_cast<size_t>(row) + 1];
          bias = a.bias[static_cast<size_t>(b) * a.P + p];
        }
        valid = a.ids[row] >= 0;
        sk[i] = f;
        if (!valid) sc[i] = -INFINITY;
      }
      // one shared atomic a warp: the valid lanes take consecutive slots
      const unsigned vm = __ballot_sync(0xffffffffu, valid);
      int j0 = 0;
      if (lane == 0 && vm) j0 = atomicAdd(&nv_s, __popc(vm));
      j0 = __shfl_sync(0xffffffffu, j0, 0);
      if (!valid) continue;
      const int j = j0 + __popc(vm & ((1u << lane) - 1));
      rows.pos[j] = i;
      rows.row[j] = row;
      if constexpr (kScaled) {
        rows.s_lo[j] = s_lo;
        rows.s_hi[j] = s_hi;
        rows.bias[j] = bias;
      }
    }
    __syncthreads();
    trace(2);
    // phase B: the warps score the listed rows
    const int nv = nv_s;
    if constexpr (kRoute == kF32Vec)
      score_f32<true>(a, qs, rows, nv, sc, warp, lane);
    else if constexpr (kRoute == kF32Scalar)
      score_f32<false>(a, qs, rows, nv, sc, warp, lane);
    else if constexpr (kRoute == kI8Wide)
      score_int8_wide(a, qs, rows, nv, sc, warp, lane);
    else
      score_int8_warp<kRoute == kI8Char4>(a, qs, rows, nv, sc, warp, lane);
    __syncthreads();
    trace(3);
    if (warp == 0) {
      int cands = m;
      if (c0 > r0) {                    // fold in the list of earlier chunks
        for (int j = lane; j < k; j += 32) {
          sc[m + j] = lv[j];
          sk[m + j] = lk[j];
        }
        __syncwarp();
        cands += k;
      }
      if (cands <= 32)                  // one word a lane, sorted
        warp_sort32_topk(sc, sk, cands, k, lane, lv, lk);
      else if (cands <= 64)             // each lane's list in registers
        warp_select_topk<2>(sc, sk, cands, k, lane, lv, lk);
      else if (cands <= 128)
        warp_select_topk<4>(sc, sk, cands, k, lane, lv, lk);
      else                              // k rounds over shared memory
        warp_topk(sc, sk, cands, k, lane, [&](int j, float v, int key) {
          lv[j] = v;
          lk[j] = key;
        });
      if (lane == 0) nv_s = 0;
    }
    __syncthreads();
    trace(4);
  }

  const size_t row_base = static_cast<size_t>(b) * a.stride;
  const size_t mine = row_base + static_cast<size_t>(blockIdx.x) * k;
  for (int j = tid; j < k; j += kThreads) {
    a.list_v[mine + j] = lv[j];
    a.list_k[mine + j] = lk[j];
  }
  trace(5);
  if (!has_kernels::arrive(a.tickets + b, L, &flag_s)) return;
  trace(6);

  // the last CTA of query b: merge the L sorted lists by their heads
  float* wv = reinterpret_cast<float*>(words);        // [kWarps][k]
  int* wk = reinterpret_cast<int*>(wv + kWarps * k);
  int* fk = words + region_words(k, L, kScaled, a.stage);  // [k] final keys
  const float* src_v = a.list_v + row_base;
  const int* src_k = a.list_k + row_base;
  if (a.stage) {                     // L2 -> shared, every load in flight
    float* cv = reinterpret_cast<float*>(wk + kWarps * k);
    int* ck = reinterpret_cast<int*>(cv + L * k);
    for (int i = tid; i < L * k; i += kThreads) {
      cv[i] = __ldcg(src_v + i);
      ck[i] = __ldcg(src_k + i);
    }
    __syncthreads();
    trace(7);
    src_v = cv;
    src_k = ck;
  }
  const int per = (L + kWarps - 1) / kWarps;
  const int l0 = min(L, warp * per);
  const int nl = min(L, l0 + per) - l0;
  warp_merge(src_v + static_cast<size_t>(l0) * k,
             src_k + static_cast<size_t>(l0) * k, k, nl, k, lane,
             [&](int j, float v, int key) {
               wv[warp * k + j] = v;
               wk[warp * k + j] = key;
             });
  __syncthreads();
  trace(8);
  if (warp != 0) return;
  warp_merge(wv, wk, k, kWarps, k, lane, [&](int j, float v, int key) {
    a.out_v[static_cast<size_t>(b) * k + j] = v;
    fk[j] = v > -INFINITY ? key : -1;
  });
  __syncwarp();
  trace(9);
  for (int j = lane; j < k; j += 32) {  // the ids, every lookup in flight
    const int key = fk[j];
    int id = -1;
    if (key >= 0) {
      const int p = key / cap;
      id = a.ids[static_cast<size_t>(bucket_of(a, b, p)) * cap +
                 (key - p * cap)];
    }
    a.out_i[static_cast<size_t>(b) * k + j] = id;
  }
  trace(10);
}

template <Route kRoute>
int launch(Scan a, int B, int L, size_t smem, cudaStream_t st) {
  auto kernel = ivf_range_kernel<kRoute>;
  const cudaError_t err = has_kernels::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(L, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch: q [B,d] f32, probe [B,P] i32, vecs [C,cap,d] (f32, or int8
// residual codes when scales [C,cap,2] and bias [B,P] are given; d even),
// ids [C,cap] i32 -> out_v [B,k] f32, out_i [B,k] i32.  L ranges per query
// (1..256); tickets [B] zero on entry (and on return); list_v / list_k
// [B, stride] scratch with stride >= L*k.  P*cap and C*cap < 2^31.
int has_ivf_scan(const float* q, const int* probe, const void* vecs,
                 const float* scales, const float* bias, const int* ids,
                 int* tickets, float* list_v, int* list_k, float* out_v,
                 int* out_i, int B, int P, int C, int cap, int d, int k,
                 int L, int stride, void* stream) {
  if (L < 1 || L > 32 * kWarps || stride < L * k)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool scaled = scales != nullptr;
  const int stage = (static_cast<size_t>(kWarps) + L) * k * 8 <= kStageBytes;
  const size_t smem = (static_cast<size_t>((d + 3) & ~3) +
                       region_words(k, L, scaled, stage) + k) * 4;
  const Scan a{q, probe, vecs, scales, bias, ids, tickets, list_v, list_k,
               out_v, out_i, P, C, cap, d, k, stride, stage};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vecs);
  if (!scaled)
    return d % 4 == 0 && addr % 16 == 0
               ? launch<kF32Vec>(a, B, L, smem, st)
               : launch<kF32Scalar>(a, B, L, smem, st);
  if (d % 32 == 0 && addr % 16 == 0)
    return launch<kI8Wide>(a, B, L, smem, st);
  return d % 8 == 0 && addr % 4 == 0 ? launch<kI8Char4>(a, B, L, smem, st)
                                     : launch<kI8Scalar>(a, B, L, smem, st);
}

#ifdef IVF_SCAN_TRACE
// The phase stamps of the last traced launch: n words into host memory.
int has_ivf_scan_trace(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, n * 8));
}
#endif

}  // extern "C"
