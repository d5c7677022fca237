// Flash-decoding: one query token per sequence against a GQA KV cache.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel (Pallas,
// TPU).  q [B, H, D], k/v cache [B, S, Hkv, D] (bf16 or f32, all three of
// one type), query head h reads KV head h / (H / Hkv).  Positions
// t <= cache_len (and t < S) are attended, scores are scaled by D^-0.5 and
// the softmax runs in f32; out [B, H, D] f32 is acc / max(l, 1e-30), so a
// sequence with no valid position gets zeros, as on the TPU.
//
// What bounds it on an H100: bytes.  Every valid K and V row is read once
// (the RAG shape B=8, S=2112, Hkv=2, D=128 bf16 reads 17.3 MB, ~5.2 us at
// 3.35 TB/s).  With chatglm3's GQA the G = 16 query heads of a KV head
// put 16 flops on every K/V byte: about 54 TFLOP/s at the byte rate,
// which the f32 CUDA cores (67 TFLOP/s, an operand from shared memory on
// every FMA) cannot sustain, but which is ~5% of the bf16 tensor cores.
//
// The bf16 path (decode_attn_mma_kernel; the RAG generator's):
// - One CTA per (chunk of S, KV head, batch row), 4 warps.  The G query
//   heads of the KV head are the M rows of mma.sync.m16n8k16 tiles (G
//   padded to 16; 17-32 take two tiles).  wgmma needs M = 64 rows per
//   warpgroup, which one KV head's group (4-32 heads) cannot fill without
//   wasting most of the tensor work and registers, and the kernel is bound
//   by bytes, not by tensor throughput; so mma.sync is the unit.
// - K/V stream through a ring of 4 stages (3 for D = 256) of 64 positions
//   in shared memory, in bf16, filled by 16-byte cp.async; the copies of
//   the next tiles stay in flight while the current tile is scored
//   (96 KB in flight per SM at D = 128).  Rows are padded by 16 bytes so
//   that ldmatrix reads them without bank conflicts.
// - Each warp owns 16 positions of a tile: S = Q K^T on tensor cores (K
//   through ldmatrix, f32 accumulation: the bf16 products are exact),
//   masking and scaling in registers, an online softmax per query-head row
//   of the MMA fragment, then O += P V on tensor cores (V through
//   ldmatrix.trans).  P stays f32 to ~24 bits: it is split into three bf16
//   parts, p = hi + mid + lo (each difference is exact), and the three
//   products are summed in f32, 3x the PV tensor work, still a few % of
//   the bf16 peak.
// - The 4 warps' (m, l, O) are merged in shared memory at the end of the
//   chunk.  One launch per call: where one chunk covers the valid
//   positions the CTA writes the output; otherwise it writes a partial to
//   scratch and the last CTA of its (b, kvh) row to arrive (an atomic
//   ticket, reset by that CTA) rescales and sums the partials.  Above 16
//   chunks the partials merge in two levels of ~sqrt(chunks) each, so no
//   single CTA reads all of them.
//
// The f32 path (decode_attn_simt_kernel; the TPU signature Hkv == H and
// the f32 cases, off the main path) and bf16 shapes the MMA kernel does
// not take (D outside 64/128/256, or G > 16 at D = 256) run a SIMT body:
// 32-position tiles widened to f32 in shared memory, lane = position for
// the scores, threads = dims for P V, with the same single-launch merge.  Chunks wholly past
// cache_len do nothing: the TPU kernel's guard against exp(-inf - -inf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kThreads = 128;                 // 4 warps, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMembers = 32;               // partials merged at once

// cache_len: a host int, or a 0-d int32 / int64 tensor on the device.
struct Len {
  const void* ptr;
  int is64;
  int host;
  __device__ __forceinline__ int read() const {
    long long x = host;
    if (ptr != nullptr)
      x = is64 ? *static_cast<const long long*>(ptr)
               : static_cast<long long>(*static_cast<const int*>(ptr));
    return static_cast<int>(x < -1 ? -1 : (x > (1 << 30) ? (1 << 30) : x));
  }
};

// Scratch of the cross-CTA merge.  Per (b, kvh) row: tstride tickets
// (0: the last level, 1 + g: group g of the first) and `slots` partials
// (chunks 0..nc-1, then one per group): ml [G][2] (m, l) and acc [G][D].
struct Scratch {
  int* tickets;
  float* ml;
  float* acc;
  int nc, gs, slots, tstride;
};

// ---------------------------------------------------------------------------
// The merge shared by both kernels
// ---------------------------------------------------------------------------

// True in every thread of the CTA that arrives last at ticket `tix` of
// `row`, out of `members`; that CTA resets the ticket.
__device__ bool arrive(const Scratch& sc, int row, int tix, int members,
                       int* flag_s) {
  return has_kernels::arrive(
      sc.tickets + static_cast<size_t>(row) * sc.tstride + tix, members,
      flag_s);
}

// Merge partial slots [s0, s0+n) of `row`: out = sum_j acc_j w_j /
// max(sum_j l_j w_j, 1e-30), w_j = e^(m_j - max m), into out_h (if not
// null) or into slot `dst` as a new partial.  Every load is issued before
// its use (float4, four slots at a time): the partials sit in L2, and a
// chain of dependent loads would cost its latency per element.
// work_s: >= work_floats(G) floats.  D % 4 == 0, acc 16-byte aligned.
__host__ __device__ constexpr int work_floats(int G) {
  return G * (2 * kMaxMembers + 2);
}

template <int NT>
__device__ void merge_slots(const Scratch& sc, int row, int G, int D, int s0,
                            int n, float* work_s, float* out_h, int dst) {
  float* w_s = work_s;                        // [G][n]: m, then the weight
  float* lj_s = w_s + G * n;                  // [G][n]
  float* mx_s = lj_s + G * n;                 // [G]
  float* l_s = mx_s + G;                      // [G]
  const size_t base = static_cast<size_t>(row) * sc.slots;
  for (int i = threadIdx.x; i < G * n; i += NT) {
    const int g = i / n, j = i - g * n;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(
        sc.ml + ((base + s0 + j) * G + g) * 2));
    w_s[i] = ml.x;
    lj_s[i] = ml.y;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += NT) {
    float big = -INFINITY;
    for (int j = 0; j < n; ++j) big = fmaxf(big, w_s[g * n + j]);
    float l = 0.f;
    for (int j = 0; j < n; ++j) {
      const float w = expf(w_s[g * n + j] - big);
      w_s[g * n + j] = w;
      l += lj_s[g * n + j] * w;
    }
    mx_s[g] = big;
    l_s[g] = l;
  }
  __syncthreads();
  const size_t gd = static_cast<size_t>(G) * D;
  const float4* acc4 = reinterpret_cast<const float4*>(sc.acc);
  for (int i = threadIdx.x; i < G * D / 4; i += NT) {
    const int g = 4 * i / D;
    const float* w = w_s + g * n;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = __ldcg(acc4 + ((base + s0 + j + u) * gd) / 4 + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a.x += x[u].x * w[j + u];
        a.y += x[u].y * w[j + u];
        a.z += x[u].z * w[j + u];
        a.w += x[u].w * w[j + u];
      }
    }
    for (; j < n; ++j) {
      const float4 x = __ldcg(acc4 + ((base + s0 + j) * gd) / 4 + i);
      a.x += x.x * w[j];
      a.y += x.y * w[j];
      a.z += x.z * w[j];
      a.w += x.w * w[j];
    }
    if (out_h != nullptr) {
      const float inv = fmaxf(l_s[g], 1e-30f);
      reinterpret_cast<float4*>(out_h)[i] =
          make_float4(a.x / inv, a.y / inv, a.z / inv, a.w / inv);
    } else {
      reinterpret_cast<float4*>(sc.acc + (base + dst) * gd)[i] = a;
    }
  }
  if (out_h == nullptr)
    for (int g = threadIdx.x; g < G; g += NT) {
      sc.ml[((base + dst) * G + g) * 2] = mx_s[g];
      sc.ml[((base + dst) * G + g) * 2 + 1] = l_s[g];
    }
}

// A CTA's partial of chunk c (m_s, l_s [G], acc_s [G][D] in shared memory)
// becomes the output, or joins the merge of its row (see the header).
template <int NT>
__device__ void finish(const float* m_s, const float* l_s, const float* acc_s,
                       float* work_s, int* flag_s, int G, int D, int row,
                       int c, int used, const Scratch& sc, float* out_h) {
  if (used == 1) {
    for (int i = threadIdx.x; i < G * D; i += NT)
      out_h[i] = acc_s[i] / fmaxf(l_s[i / D], 1e-30f);
    return;
  }
  const size_t base = static_cast<size_t>(row) * sc.slots;
  const size_t gd = static_cast<size_t>(G) * D;
  for (int g = threadIdx.x; g < G; g += NT) {
    sc.ml[((base + c) * G + g) * 2] = m_s[g];
    sc.ml[((base + c) * G + g) * 2 + 1] = l_s[g];
  }
  for (int i = threadIdx.x; i < G * D / 4; i += NT)
    reinterpret_cast<float4*>(sc.acc + (base + c) * gd)[i] =
        reinterpret_cast<const float4*>(acc_s)[i];
  const int n_groups = (used + sc.gs - 1) / sc.gs;
  if (n_groups == 1) {
    if (arrive(sc, row, 0, used, flag_s))
      merge_slots<NT>(sc, row, G, D, 0, used, work_s, out_h, 0);
    return;
  }
  const int grp = c / sc.gs;
  const int first = grp * sc.gs;
  if (!arrive(sc, row, 1 + grp, min(sc.gs, used - first), flag_s)) return;
  merge_slots<NT>(sc, row, G, D, first, min(sc.gs, used - first), work_s,
                  nullptr, sc.nc + grp);
  if (arrive(sc, row, 0, n_groups, flag_s))
    merge_slots<NT>(sc, row, G, D, sc.nc, n_groups, work_s, out_h, 0);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kTN = 64;                       // positions per stage
constexpr int kWarpPos = kTN / kWarps;        // 16: one MMA k-step of P V
constexpr int kPad = 8;                       // bf16 per row: 16 bytes

template <int D>
struct MmaCfg {
  static constexpr int kRow = D + kPad;       // smem row, bf16
  static constexpr int kStages = D <= 128 ? 4 : 3;
  static constexpr int kStage = 2 * kTN * kRow;   // K tile, then V tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory (zero-filled past src_bytes), with a
// 256-byte L2 prefetch: a K/V row of one head is 256 contiguous bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8 f32] += a[16x16 bf16, row] * b[16x8 bf16, col]
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 t = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// p = hi + mid + lo exactly to ~24 bits: each remainder is exact in f32
__device__ __forceinline__ void split3(float p, __nv_bfloat16* part) {
  part[0] = __float2bfloat16_rn(p);
  const float r1 = p - __bfloat162float(part[0]);
  part[1] = __float2bfloat16_rn(r1);
  part[2] = __float2bfloat16_rn(r1 - __bfloat162float(part[1]));
}

template <int D, int MT>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
             (MmaCfg<D>::kStages * MmaCfg<D>::kStage +
              MT * 16 * MmaCfg<D>::kRow) +
         sizeof(float) * (2 * kWarps + 2) * MT * 16 + 16;
}

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
decode_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, Len len,
                       Scratch sc, float* __restrict__ out, int H, int Hkv,
                       int S, int chunk, float scale) {
  using C = MmaCfg<D>;
  constexpr int kM = MT * 16;                 // padded query-head rows
  constexpr int kND = D / 8;                  // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* q_s = stages + C::kStages * C::kStage;
  float* wm_s = reinterpret_cast<float*>(q_s + kM * C::kRow);  // [warp][kM]
  float* wl_s = wm_s + kWarps * kM;                            // [warp][kM]
  float* m_s = wl_s + kWarps * kM;                             // [kM]
  float* l_s = m_s + kM;                                       // [kM]
  int* flag_s = reinterpret_cast<int*>(l_s + kM);

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int n_valid = min(S, len.read() + 1);
  const int used = n_valid > 0 ? (n_valid + chunk - 1) / chunk : 0;
  const int start = c * chunk;
  const int end = min(start + chunk, n_valid);
  float* out_h = out + (static_cast<size_t>(b) * H +
                        static_cast<size_t>(kvh) * G) * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (start >= end) {                         // wholly masked
    if (used == 0 && c == 0)
      for (int i = tid; i < G * D; i += kThreads) out_h[i] = 0.f;
    return;
  }

  const int n_tiles = (end - start + kTN - 1) / kTN;
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* k_row0 =
      k + (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  const __nv_bfloat16* v_row0 =
      v + (static_cast<size_t>(b) * S * Hkv + kvh) * D;
  auto load_tile = [&](int tile) {
    __nv_bfloat16* ks = stages + (tile % C::kStages) * C::kStage;
    __nv_bfloat16* vs = ks + kTN * C::kRow;
    const int t0 = start + tile * kTN;
    for (int i = tid; i < kTN * (D / 8); i += kThreads) {
      const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
      const int t = t0 + r;
      const bool ok = t < end;               // zero-fill past the chunk
      const size_t off = static_cast<size_t>(ok ? t : start) * row_stride + cv;
      cp_async16(ks + r * C::kRow + cv, k_row0 + off, ok ? 16 : 0);
      cp_async16(vs + r * C::kRow + cv, v_row0 + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // Q rows of the group, zero-padded to kM (after the first copies are
  // under way)
  const __nv_bfloat16* q_h = q + (static_cast<size_t>(b) * H +
                                  static_cast<size_t>(kvh) * G) * D;
  for (int i = tid; i < kM * (D / 8); i += kThreads) {
    const int r = i / (D / 8), cv = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < G) x = *reinterpret_cast<const uint4*>(q_h + r * D + cv);
    *reinterpret_cast<uint4*>(q_s + r * C::kRow + cv) = x;
  }

  float o[MT][kND][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[mt][h] = -INFINITY;
      l_run[mt][h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  }
  const int mat = lane >> 3, mr = lane & 7;   // ldmatrix address roles
  const int qcol = (lane & 3) * 2;            // fragment column pair

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();                          // tile ready, slot free
    if (tile + C::kStages - 1 < n_tiles) load_tile(tile + C::kStages - 1);
    cp_async_commit();

    const int wp0 = start + tile * kTN + warp * kWarpPos;
    if (wp0 >= end) continue;                 // warp-uniform; >= 1 valid
    const __nv_bfloat16* ks =
        stages + (tile % C::kStages) * C::kStage + warp * kWarpPos * C::kRow;
    const __nv_bfloat16* vs = ks + kTN * C::kRow;

    // S = Q K^T over the warp's 16 positions (two n-tiles of 8)
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + ((mat >> 1) * 8 + mr) * C::kRow + kk * 16 +
                      (mat & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldsm_x4(qa, q_s + (mt * 16 + (mat & 1) * 8 + mr) * C::kRow +
                        kk * 16 + (mat >> 1) * 8);
        mma_bf16(s[mt][0], qa, kb[0], kb[1]);
        mma_bf16(s[mt][1], qa, kb[2], kb[3]);
      }
    }

    // online softmax per row (h = 0: rows lane/4, h = 1: rows lane/4 + 8)
    uint32_t pa[MT][3][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = wp0 + nt * 8 + qcol + (e & 1);
          s[mt][nt][e] = t < end ? s[mt][nt][e] * scale : -INFINITY;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(fmaxf(s[mt][0][2 * h], s[mt][0][2 * h + 1]),
                         fmaxf(s[mt][1][2 * h], s[mt][1][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][h], mx);        // finite
        const float alpha = expf(m_run[mt][h] - m_new);     // 0 at first
        m_run[mt][h] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            const float p = expf(s[mt][nt][e] - m_new);      // 0 if masked
            s[mt][nt][e] = p;
            ps += p;
          }
        l_run[mt][h] = l_run[mt][h] * alpha + ps;
#pragma unroll
        for (int j = 0; j < kND; ++j) {
          o[mt][j][2 * h] *= alpha;
          o[mt][j][2 * h + 1] *= alpha;
        }
      }
      // P as the A operand: the C fragments of two n-tiles are the A
      // fragment of one k16 step; three bf16 parts per value
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat16 p0[3], p1[3];
          split3(s[mt][nt][2 * h], p0);
          split3(s[mt][nt][2 * h + 1], p1);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            pa[mt][part][nt * 2 + h] = pack_bf16(p0[part], p1[part]);
        }
    }

    // O += P V, smallest part first
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, vs + ((mat & 1) * 8 + mr) * C::kRow + dp * 16 +
                            (mat >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int part = 2; part >= 0; --part) {
          mma_bf16(o[mt][2 * dp], pa[mt][part], vb[0], vb[1]);
          mma_bf16(o[mt][2 * dp + 1], pa[mt][part], vb[2], vb[3]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                            // the ring is free

  // merge the four warps in shared memory: o_s [warp][kM][D] f32
  float* o_s = reinterpret_cast<float*>(stages);
  const int r0 = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if ((lane & 3) == 0) {
        wm_s[warp * kM + mt * 16 + h * 8 + r0] = m_run[mt][h];
        wl_s[warp * kM + mt * 16 + h * 8 + r0] = l;
      }
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + h * 8 + r0;
      float big = wm_s[row];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) big = fmaxf(big, wm_s[w * kM + row]);
      const float f = expf(m_run[mt][h] - big);   // 0 for an idle warp
      float* dst = o_s + (warp * kM + row) * D + qcol;
#pragma unroll
      for (int j = 0; j < kND; ++j) {
        dst[j * 8] = o[mt][j][2 * h] * f;
        dst[j * 8 + 1] = o[mt][j][2 * h + 1] * f;
      }
    }
  if (tid < G) {
    float big = wm_s[tid];
    for (int w = 1; w < kWarps; ++w) big = fmaxf(big, wm_s[w * kM + tid]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w)
      l += wl_s[w * kM + tid] * expf(wm_s[w * kM + tid] - big);
    m_s[tid] = big;
    l_s[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float a = o_s[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += o_s[w * kM * D + i];
    o_s[i] = a;                               // acc [G][D] in warp 0's slot
  }
  __syncthreads();
  finish<kThreads>(m_s, l_s, o_s, o_s + kM * D, flag_s, G, D,
                   b * Hkv + kvh, c, used, sc, out_h);
}

// ---------------------------------------------------------------------------
// f32 (and bf16 shapes outside the MMA kernel): SIMT
// ---------------------------------------------------------------------------

constexpr int kTile = 32;                     // positions per staged tile
constexpr int kMaxD = 256;
constexpr int kDimsPerThread = kMaxD / kThreads;

template <typename T>
struct Vec;                                   // 16-byte loads of T -> f32

template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  }
  static __device__ __forceinline__ float one(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float one(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

// Shared memory, in floats: q [G][D] (then acc) | k [kTile][D+1] | v
// [kTile][D] | p [G][kTile] | alpha [G] | m [G] | l [G] | flag | the
// merge's work space.  The odd K row stride keeps the score pass (lane =
// row) free of bank conflicts.
__host__ __device__ inline size_t simt_smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D + static_cast<size_t>(kTile) * (D + 1) +
         static_cast<size_t>(kTile) * D + static_cast<size_t>(G) * kTile +
         3 * static_cast<size_t>(G) + 4 + work_floats(G);
}

template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attn_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, Len len, Scratch sc,
                        float* __restrict__ out, int H, int Hkv, int S, int D,
                        int chunk, float scale) {
  constexpr int kHeadsPerWarp = (GMAX + kWarps - 1) / kWarps;
  constexpr int VN = Vec<T>::n;
  extern __shared__ __align__(16) float dsmem[];
  const int G = H / Hkv;
  float* q_s = dsmem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + kTile * (D + 1);
  float* p_s = v_s + kTile * D;
  float* alpha_s = p_s + G * kTile;
  float* m_s = alpha_s + G;
  float* l_s = m_s + G;
  int* flag_s = reinterpret_cast<int*>(l_s + G);
  float* work_s = l_s + G + 4;

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_valid = min(S, len.read() + 1);
  const int used = n_valid > 0 ? (n_valid + chunk - 1) / chunk : 0;
  const int start = c * chunk;
  const int end = min(start + chunk, n_valid);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  float* out_h = out + head0 * D;
  if (start >= end) {                         // wholly masked
    if (used == 0 && c == 0)
      for (int i = tid; i < G * D; i += kThreads) out_h[i] = 0.f;
    return;
  }

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = Vec<T>::one(q[head0 * D + i]);

  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }
  float acc[GMAX][kDimsPerThread];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] = 0.f;

  const int vec_per_row = D / VN;
  for (int t0 = start; t0 < end; t0 += kTile) {
    const int nt = min(kTile, end - t0);
    __syncthreads();                          // previous tile fully consumed
    for (int i = tid; i < kTile * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int col = (i - r * vec_per_row) * VN;
      float kf[VN], vf[VN];
      if (r < nt) {
        const size_t off =
            ((static_cast<size_t>(b) * S + t0 + r) * Hkv + kvh) * D + col;
        Vec<T>::load(k + off, kf);
        Vec<T>::load(v + off, vf);
      } else {
#pragma unroll
        for (int u = 0; u < VN; ++u) kf[u] = vf[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        k_s[r * (D + 1) + col + u] = kf[u];
        v_s[r * D + col + u] = vf[u];
      }
    }
    __syncthreads();

    // scores of position `lane` for the warp's heads w, w+4, ...
    float s[kHeadsPerWarp];
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) s[j] = 0.f;
    const float* kr = k_s + lane * (D + 1);
    for (int d = 0; d < D; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const int g = warp + kWarps * j;
        if (g < G) {
          const float4 qq = *reinterpret_cast<const float4*>(q_s + g * D + d);
          s[j] = fmaf(qq.x, k0, s[j]);
          s[j] = fmaf(qq.y, k1, s[j]);
          s[j] = fmaf(qq.z, k2, s[j]);
          s[j] = fmaf(qq.w, k3, s[j]);
        }
      }
    }
    const bool valid = lane < nt;             // nt >= 1: lane 0 is valid
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + kWarps * j;
      if (g >= G) continue;                   // warp-uniform
      const float sc_ = valid ? s[j] * scale : -INFINITY;
      float mt = sc_;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m_run[j], mt);          // finite
      const float alpha = expf(m_run[j] - m_new);       // 0 on the first tile
      const float p = valid ? expf(sc_ - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_run[j] = l_run[j] * alpha + ps;
      m_run[j] = m_new;
      p_s[g * kTile + lane] = p;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_t p[g][t] v[t][d]; rows >= nt are zero
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d >= D) continue;
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g][i] *= alpha_s[g];
      for (int t = 0; t < kTile; t += 4) {
        const float v0 = v_s[t * D + d], v1 = v_s[(t + 1) * D + d];
        const float v2 = v_s[(t + 2) * D + d], v3 = v_s[(t + 3) * D + d];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(p_s + g * kTile + t);
            float a = acc[g][i];
            a = fmaf(p4.x, v0, a);
            a = fmaf(p4.y, v1, a);
            a = fmaf(p4.z, v2, a);
            a = fmaf(p4.w, v3, a);
            acc[g][i] = a;
          }
        }
      }
    }
  }

  __syncthreads();                            // q_s becomes acc [G][D]
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int g = warp + kWarps * j;
    if (g < G && lane == 0) {
      m_s[g] = m_run[j];
      l_s[g] = l_run[j];
    }
  }
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) q_s[g * D + d] = acc[g][i];
  }
  __syncthreads();
  finish<kThreads>(m_s, l_s, q_s, work_s, flag_s, G, D, b * Hkv + kvh, c,
                   used, sc, out_h);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D, int MT>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const void* q,
                       const void* k, const void* v, Len len, Scratch sc,
                       float* out, int H, int Hkv, int S, int chunk,
                       float scale) {
  constexpr size_t smem = mma_smem_bytes<D, MT>();
  auto kernel = decode_attn_mma_kernel<D, MT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), len, sc, out, H, Hkv, S, chunk,
      scale);
  return cudaGetLastError();
}

template <typename T, int GMAX>
cudaError_t launch_simt(dim3 grid, cudaStream_t st, const void* q,
                        const void* k, const void* v, Len len, Scratch sc,
                        float* out, int H, int Hkv, int S, int D, int chunk,
                        float scale) {
  const size_t smem = simt_smem_floats(H / Hkv, D) * sizeof(float);
  auto kernel = decode_attn_simt_kernel<T, GMAX>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, sc, out, H, Hkv, S, D, chunk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t simt_by_group(int G, dim3 grid, cudaStream_t st, const void* q,
                          const void* k, const void* v, Len len, Scratch sc,
                          float* out, int H, int Hkv, int S, int D, int chunk,
                          float scale) {
  const int gmax = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : G <= 8 ? 8
                 : G <= 16 ? 16 : G <= 32 ? 32 : 0;
#define HAS_DECODE_CASE(G_)                                             \
  case G_:                                                              \
    return launch_simt<T, G_>(grid, st, q, k, v, len, sc, out, H, Hkv, \
                              S, D, chunk, scale);
  switch (gmax) {
    HAS_DECODE_CASE(1)
    HAS_DECODE_CASE(2)
    HAS_DECODE_CASE(4)
    HAS_DECODE_CASE(8)
    HAS_DECODE_CASE(16)
    HAS_DECODE_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef HAS_DECODE_CASE
}

}  // namespace

extern "C" {

// q [B,H,D], k/v [B,S,Hkv,D] (bf16 if is_bf16, else f32); the cache
// length is len_ptr (a device int32, or int64 if len_is64) or, when
// len_ptr is null, len_host; out [B,H,D] f32.  chunk (a multiple of 64)
// and nc = ceil(covered / chunk) cut S; partials merge in groups of gs
// (gs >= nc: one level).  tickets [B*Hkv*tstride] int32 are zero and are
// left zero; part_ml [B*Hkv*slots*G*2] and part_acc [B*Hkv*slots*G*D] f32,
// slots = nc + ceil(nc / gs), tstride = 1 + ceil(nc / gs) (unused when
// nc == 1).  use_mma picks the tensor-core kernel: bf16, D in {64, 128,
// 256}, G <= 32 (G <= 16 at D = 256).  Otherwise D % 8 == 0 (bf16) or
// D % 4 == 0 (f32), D <= 256, G <= 32.  scale is D^-0.5 rounded once to
// f32, as the reference multiplies.
int has_decode_attention(const void* q, const void* k, const void* v,
                         const void* len_ptr, int len_is64, int len_host,
                         int* tickets, float* part_ml, float* part_acc,
                         float* out, int B, int H, int Hkv, int S, int D,
                         int chunk, int nc, int gs, int tstride, float scale,
                         int is_bf16, int use_mma, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Len len{len_ptr, len_is64, len_host};
  const int n_groups = (nc + gs - 1) / gs;
  const Scratch sc{tickets, part_ml, part_acc, nc, gs, nc + n_groups,
                   tstride};
  if (nc > 1 && (gs > kMaxMembers || n_groups > kMaxMembers ||
                 tstride < 1 + n_groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nc, Hkv, B);
  const int G = H / Hkv;
  cudaError_t err;
  if (use_mma) {
    if (!is_bf16 || G > 32 || (D == 256 && G > 16))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool two = G > 16;
    if (D == 64)
      err = two ? launch_mma<64, 2>(grid, st, q, k, v, len, sc, out, H, Hkv,
                                    S, chunk, scale)
                : launch_mma<64, 1>(grid, st, q, k, v, len, sc, out, H, Hkv,
                                    S, chunk, scale);
    else if (D == 128)
      err = two ? launch_mma<128, 2>(grid, st, q, k, v, len, sc, out, H,
                                     Hkv, S, chunk, scale)
                : launch_mma<128, 1>(grid, st, q, k, v, len, sc, out, H,
                                     Hkv, S, chunk, scale);
    else if (D == 256)
      err = launch_mma<256, 1>(grid, st, q, k, v, len, sc, out, H, Hkv, S,
                               chunk, scale);
    else
      err = cudaErrorInvalidValue;
  } else {
    err = is_bf16 ? simt_by_group<__nv_bfloat16>(G, grid, st, q, k, v, len,
                                                 sc, out, H, Hkv, S, D,
                                                 chunk, scale)
                  : simt_by_group<float>(G, grid, st, q, k, v, len, sc, out,
                                         H, Hkv, S, D, chunk, scale);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of the kernel a call with these
// arguments launches (for reports).
int has_decode_attention_smem(int D, int G, int is_bf16, int use_mma) {
  if (!use_mma)
    return static_cast<int>(simt_smem_floats(G, D) * sizeof(float));
  if (!is_bf16 || G > 32 || (D == 256 && G > 16)) return -1;
  const bool two = G > 16;
  if (D == 64)
    return static_cast<int>(two ? mma_smem_bytes<64, 2>()
                                : mma_smem_bytes<64, 1>());
  if (D == 128)
    return static_cast<int>(two ? mma_smem_bytes<128, 2>()
                                : mma_smem_bytes<128, 1>());
  return D == 256 ? static_cast<int>(mma_smem_bytes<256, 1>()) : -1;
}

}  // extern "C"
