// RRF fusion + near-duplicate diversification + rerank of a hybrid pool,
// and the final top-k of the fused pool, in one launch.
//
// Replaces src/repro/kernels/fused_rerank.py::_fused_kernel (Pallas, TPU)
// and the two-key sort the reference runs after it (_final_topk): one
// query's pool of P = kd dense + kl lexical slots (-1 = invalid) ->
//   mass[i]   = sum over slots j holding the same valid id of 1/(rrf_k +
//               rank_j), in slot order, on the id's first slot (0 elsewhere
//               and on invalid slots);
//   rscore[i] = vec_i . q;
// with diversify, the slots of positive mass are visited by (mass desc,
// slot asc) and one is kept iff its cosine (norms floored at 1e-12) to
// every kept slot is below diversify_sim; without, every slot of positive
// mass is kept.  Kept slots carry their mass, the others -inf.  The output
// is the first min(k, P) slots in the order (mass desc, rscore desc, slot
// asc): their masses, and their ids (-1 where the mass is -inf).
//
// What bounds it on an H100: latency.  At the cloud stage's shape (B=1,
// P=20, d=768) it reads 61 KB and does about 0.7 M flops: tens of
// nanoseconds of either.  What is left is a chain of dependent steps
// inside one CTA, so the design shortens the chain:
// - staging: q and the pool go to shared memory by 16-byte cp.async, all
//   of them in flight at once, while the masses are summed;
// - one Gram pass: the (P+1) x (P+1) Gram of [q; vecs], register-tiled
//   (4 x 4 entries a thread over a slice of d, rows strided so that the
//   lanes of a warp read distinct banks), the slices' partial sums added
//   once, in a fixed order, through shared memory.  Row 0 gives the
//   rscores, the diagonal the norms, the rest the dots; a cosine is
//   dot / (max(n_i, 1e-12) * max(n_j, 1e-12)), which differs from the
//   reference's normalised product only in the last ulps;
// - the greedy pass sorted once: the argmax loop with ties to the lowest
//   slot visits the slots of positive mass in (mass desc, slot asc) order
//   (masses are >= 0, and once they run out a pick changes nothing), so a
//   warp bitonic sort gives that order, made by warp 0 while the other
//   warps run the Gram; then each lane keeps the running largest cosine
//   of its two slots to the kept set: a candidate costs one shuffle, a
//   keep one fmaxf a lane;
// - the final order by a second warp bitonic sort of 64-bit keys (mass,
//   rscore order bits) with the slot as tie key, which is the reference's
//   two stable argsorts; the top k written straight out.
// Masses are bit-equal to the plain version (rounded, uncontracted adds in
// slot order).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using has_kernels::kFull;
using has_kernels::order_bits;
using has_kernels::from_order_bits;

constexpr int kThreads = 512;
constexpr int kGramThreads = kThreads - 32;   // warp 0 sorts meanwhile
constexpr int kMaxPool = 64;          // two slots a lane of one warp
constexpr int kMaxDevices = 64;

// Phase stamps for fused_rerank_probe.py, compiled in only with
// -DFUSED_RERANK_TRACE: after a barrier, thread 0 of each CTA records
// %globaltimer at the end of each phase (kTraceMarks a CTA, for the first
// kTraceCtas CTAs); kTracePhases names the phases after the start.
#ifdef FUSED_RERANK_TRACE
constexpr int kTraceMarks = 7;
constexpr int kTraceCtas = 64;
__device__ unsigned long long g_trace[kTraceCtas * kTraceMarks];
__device__ __forceinline__ void trace(int mark) {
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < kTraceCtas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[blockIdx.x * kTraceMarks + mark] = t;
  }
}
#else
__device__ __forceinline__ void trace(int) {}
#endif
const char kTracePhases[] =
    "staging and masses,gram (warp 0: greedy sort),gram reduction,"
    "norms and cosines,greedy walk,final sort and writes";

struct Fused {
  const float* q;           // [B, d]
  const int* ids;           // [B, P]
  const float* vecs;        // [B, P, d]
  float* out_mass;          // [B, P] or null
  float* out_rscore;        // [B, P] or null
  float* out_vals;          // [B, kk] or null
  int* out_ids;             // [B, kk] or null
  int P, kd, d, kk;
  float rrf_k, dsim;
  int diversify;
};

// Shared-memory layout: rows [Rp][Ds] (q, the pool, zero rows up to Rp),
// reused for the Gram's partial sums and then the cosines; gram [R][R].
// Ds is d rounded up to 4, plus 4 when that is a multiple of 8 floats, so
// that consecutive rows start in distinct 16-byte bank groups.
struct Layout {
  int R, Rp, nb, Ds, region;
  __host__ __device__ Layout(int P, int d) {
    R = P + 1;
    Rp = (R + 3) & ~3;
    nb = Rp / 4;
    const int d4 = (d + 3) & ~3;
    Ds = (d4 / 4) % 2 ? d4 : d4 + 4;
    const int tiles = nb * (nb + 1) / 2;
    const int partials = (kGramThreads / tiles) * tiles * 16;
    region = Rp * Ds;
    if (region < partials) region = partials;
    if (region < P * P) region = P * P;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * (static_cast<size_t>(region) + R * R);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// a before b in a descending sort by key, ties to the lower tie key
__device__ __forceinline__ bool before(unsigned long long ka, int ta,
                                       unsigned long long kb, int tb) {
  return ka > kb || (ka == kb && ta < tb);
}

// One warp sorts 64 (key, tie) pairs, element e = r * 32 + lane in
// key[r] / tie[r], into (key desc, tie asc) order: a bitonic network of 21
// steps, 15 of them by shuffles.  Tie keys are distinct.
__device__ __forceinline__ void warp_sort64(unsigned long long (&key)[2],
                                            int (&tie)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {               // the lane's own pair, size 64
        if (before(key[1], tie[1], key[0], tie[0])) {
          const unsigned long long k = key[0];
          const int t = tie[0];
          key[0] = key[1];
          tie[0] = tie[1];
          key[1] = k;
          tie[1] = t;
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const unsigned long long ok = __shfl_xor_sync(kFull, key[r], stride);
        const int ot = __shfl_xor_sync(kFull, tie[r], stride);
        const bool desc = ((r * 32 + lane) & size) == 0;
        const bool lower = (lane & stride) == 0;
        const bool other_first = before(ok, ot, key[r], tie[r]);
        if (lower == desc ? other_first : !other_first) {
          key[r] = ok;
          tie[r] = ot;
        }
      }
    }
  }
}

// Gram tile number -> (x, y), x <= y < nb: tiles enumerate the pairs in
// row-major order of the upper triangle.
__device__ __forceinline__ void tile_xy(int tile, int nb, int& x, int& y) {
  x = 0;
  while (tile >= nb - x) {
    tile -= nb - x;
    ++x;
  }
  y = x + tile;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_topk_kernel(const Fused a) {
  extern __shared__ __align__(16) float fsmem[];
  __shared__ float raw_s[kMaxPool], mass_s[kMaxPool], rs_s[kMaxPool];
  __shared__ float norm_s[kMaxPool], sel_s[kMaxPool];
  __shared__ int ids_s[kMaxPool], order_s[kMaxPool];
  const int P = a.P, d = a.d;
  const Layout L(P, d);
  const int R = L.R, Ds = L.Ds;
  float* rows = fsmem;                     // [Rp][Ds], then partials, cos
  float* gram = fsmem + L.region;          // [R][R]
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32;
  trace(0);

  // staging: every row's copies in flight, the masses meanwhile
  if (kVec) {
    const int n4 = d / 4;
    int r = tid / n4, c = tid - r * n4;    // chunk (row r, float4 c)
    while (r < R) {
      const float* src = r == 0 ? a.q + b * d
                                : a.vecs + (b * P + r - 1) * d;
      cp_async16(rows + r * Ds + 4 * c, src + 4 * c);
      for (c += kThreads; c >= n4; c -= n4) ++r;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    const int d4 = (d + 3) & ~3;
    for (int x = tid; x < R * d4; x += kThreads) {
      const int r = x / d4, c = x - r * d4;
      const float* src = r == 0 ? a.q + b * d
                                : a.vecs + (b * P + r - 1) * d;
      rows[r * Ds + c] = c < d ? src[c] : 0.f;
    }
  }
  for (int x = R * Ds + tid; x < L.Rp * Ds; x += kThreads) rows[x] = 0.f;
  if (tid < P) {
    const int id = a.ids[b * P + tid];
    const int rank = tid < a.kd ? tid : tid - a.kd;
    ids_s[tid] = id;
    raw_s[tid] = id >= 0 ? __fdiv_rn(1.f, __fadd_rn(a.rrf_k, static_cast<float>(
                                                             rank)))
                         : 0.f;
  }
  __syncthreads();
  if (tid < P) {
    const int id = ids_s[tid];
    bool first = true;
    float m = 0.f;
    for (int j = 0; j < P; ++j) {
      const bool same = id >= 0 && ids_s[j] == id;
      first &= !(same && j < tid);
      m = __fadd_rn(m, same ? raw_s[j] : 0.f);
    }
    mass_s[tid] = (first && id >= 0) ? m : 0.f;
  }
  if (kVec) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  trace(1);

  // warp 0: the greedy order, (mass desc, slot asc), slots past P last
  int npos = 0;
  if (tid < 32 && a.diversify) {
    unsigned long long key[2];
    int tie[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = r * 32 + lane;
      const float m = e < P ? mass_s[e] : 0.f;
      npos += __popc(__ballot_sync(kFull, m > 0.f));
      key[r] = e < P ? static_cast<unsigned long long>(order_bits(m)) << 32
                     : 0ull;
      tie[r] = e;
    }
    warp_sort64(key, tie, lane);
    order_s[lane] = tie[0];
    order_s[lane + 32] = tie[1];
  }

  // the other warps: the Gram of [q; vecs], thread = (tile, slice of d's
  // float4 groups); tile (x, y) holds the rows x + i*nb and y + j*nb
  const int nb = L.nb, tiles = nb * (nb + 1) / 2;
  const int slices = kGramThreads / tiles, g4 = ((d + 3) & ~3) / 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int gid = tid - 32;
  const int tile = gid % tiles, slice = gid / tiles;
  if (gid >= 0 && slice < slices) {
    int x, y;
    tile_xy(tile, nb, x, y);
    const float4* rx = reinterpret_cast<const float4*>(rows + x * Ds);
    const float4* ry = reinterpret_cast<const float4*>(rows + y * Ds);
    const int step = nb * Ds / 4;          // one row group, in float4s
    // the next group's eight loads in flight while this one's FMAs run
    float4 u[4], v[4];
    int g = slice;
    if (g < g4)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u[i] = rx[i * step + g];
        v[i] = ry[i * step + g];
      }
    while (g < g4) {
      const int gn = g + slices;
      float4 un[4], vn[4];
      if (gn < g4)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          un[i] = rx[i * step + gn];
          vn[i] = ry[i * step + gn];
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(u[i].x, v[j].x, acc[i][j]);
          acc[i][j] = fmaf(u[i].y, v[j].y, acc[i][j]);
          acc[i][j] = fmaf(u[i].z, v[j].z, acc[i][j]);
          acc[i][j] = fmaf(u[i].w, v[j].w, acc[i][j]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        u[i] = un[i];
        v[i] = vn[i];
      }
      g = gn;
    }
  }
  __syncthreads();                         // rows are read: partials next
  if (gid >= 0 && slice < slices) {      // partials [slice][entry][tile]
    float* part = rows + slice * 16 * tiles + tile;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[(i * 4 + j) * tiles] = acc[i][j];
  }
  __syncthreads();
  trace(2);

  // each tile entry (t, i, j) with both rows real: its partials added in
  // a fixed order, written to the Gram at (row, col) and (col, row).  A
  // diagonal tile holds an entry twice, as equal sums.
  for (int e = tid; e < tiles * 16; e += kThreads) {
    const int t = e % tiles, ai = e / tiles >> 2, aj = e / tiles & 3;
    int x, y;
    tile_xy(t, nb, x, y);
    const int i = x + ai * nb, j = y + aj * nb;
    if (i >= R || j >= R) continue;
    // four chains over the slices, then their sum
    const float* p = rows + e;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    int sl = 0;
    for (; sl + 4 <= slices; sl += 4)
#pragma unroll
      for (int c = 0; c < 4; ++c) s4[c] += p[(sl + c) * 16 * tiles];
    for (; sl < slices; ++sl) s4[0] += p[sl * 16 * tiles];
    const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    gram[i * R + j] = s;
    gram[j * R + i] = s;
  }
  __syncthreads();
  trace(3);

  if (tid < P) {
    const float rs = gram[tid + 1];
    rs_s[tid] = rs;
    norm_s[tid] = fmaxf(__fsqrt_rn(gram[(tid + 1) * R + tid + 1]), 1e-12f);
    if (a.out_rscore) a.out_rscore[b * P + tid] = rs;
  }
  __syncthreads();
  float* cosv = rows;                      // [P][P]
  if (a.diversify) {
    for (int e = tid; e < P * P; e += kThreads) {
      const int i = e / P, j = e - i * P;
      cosv[e] = gram[(i + 1) * R + j + 1] / (norm_s[i] * norm_s[j]);
    }
    __syncthreads();
  }
  trace(4);

  if (tid < 32) {
    // the walk over the greedy order
    const float m0 = lane < P ? mass_s[lane] : 0.f;
    const float m1 = lane + 32 < P ? mass_s[lane + 32] : 0.f;
    bool keep0 = m0 > 0.f, keep1 = m1 > 0.f;
    if (a.diversify) {
      keep0 = keep1 = false;
      float mc0 = -INFINITY, mc1 = -INFINITY;  // largest cosine to the kept
#pragma unroll 4
      for (int r = 0; r < npos; ++r) {
        // the candidate's cosines do not depend on the walk: loaded first
        const int c = order_s[r];
        const float* row = cosv + c * P;
        const float c0 = lane < P ? row[lane] : -INFINITY;
        const float c1 = lane + 32 < P ? row[lane + 32] : -INFINITY;
        const float mc = __shfl_sync(kFull, c < 32 ? mc0 : mc1, c & 31);
        if (mc < a.dsim) {
          keep0 |= c == lane;
          keep1 |= c == lane + 32;
          mc0 = fmaxf(mc0, c0);
          mc1 = fmaxf(mc1, c1);
        }
      }
    }
    if (lane < P) {
      sel_s[lane] = keep0 ? m0 : -INFINITY;
      if (a.out_mass) a.out_mass[b * P + lane] = sel_s[lane];
    }
    if (lane + 32 < P) {
      sel_s[lane + 32] = keep1 ? m1 : -INFINITY;
      if (a.out_mass) a.out_mass[b * P + lane + 32] = sel_s[lane + 32];
    }
  }
  trace(5);

  if (tid < 32 && a.out_vals) {
    // the final order: (mass desc, rscore desc, slot asc), first kk slots
    __syncwarp();
    unsigned long long key[2];
    int tie[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = r * 32 + lane;
      key[r] = e < P ? static_cast<unsigned long long>(order_bits(sel_s[e]))
                               << 32 |
                           order_bits(rs_s[e])
                     : 0ull;
      tie[r] = e;
    }
    warp_sort64(key, tie, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r * 32 + lane;
      if (j < a.kk) {
        const float v = from_order_bits(static_cast<unsigned>(key[r] >> 32));
        a.out_vals[b * a.kk + j] = v;
        a.out_ids[b * a.kk + j] = v > -INFINITY ? ids_s[tie[r]] : -1;
      }
    }
  }
  trace(6);
}

template <bool kVec>
cudaError_t launch(const Fused& a, int B, size_t smem, cudaStream_t st) {
  // the dynamic shared memory cap, raised once per device to the most a
  // block may opt into beside the kernel's static arrays
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fused_topk_kernel<kVec>);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        fused_topk_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most - static_cast<int>(fa.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  fused_topk_kernel<kVec><<<B, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for a pool of P slots of width d.
int has_fused_rerank_smem(int P, int d) {
  return static_cast<int>(Layout(P, d).bytes());
}

// out_mass / out_rscore [B, P] and out_vals / out_ids [B, kk], kk =
// min(k, P): either pair may be null.  P <= 64.
int has_fused_rerank(const float* q, const int* pool_ids,
                     const float* pool_vecs, float* out_mass,
                     float* out_rscore, float* out_vals, int* out_ids, int B,
                     int P, int kd, int d, int kk, float rrf_k, int diversify,
                     float dsim, void* stream) {
  if (P < 1 || P > kMaxPool) return static_cast<int>(cudaErrorInvalidValue);
  const Fused a{q,        pool_ids, pool_vecs, out_mass, out_rscore,
                out_vals, out_ids,  P,         kd,       d,
                kk,       rrf_k,    dsim,      diversify};
  const size_t smem = Layout(P, d).bytes();
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pool_vecs) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<true>(a, B, smem, st)
                              : launch<false>(a, B, smem, st));
}

#ifdef FUSED_RERANK_TRACE
// The phase stamps of the last traced launch: n words into host memory.
int has_fused_rerank_trace(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, n * 8));
}
#endif

// The names of the traced phases, comma-separated, for the probe.
const char* has_fused_rerank_trace_phases() { return kTracePhases; }

}  // extern "C"
