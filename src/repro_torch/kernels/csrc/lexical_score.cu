// Hashed-term lexical scoring with the reference's streamed top-k.
//
// Replaces src/repro/kernels/lexical_score.py::_lexical_kernel (Pallas,
// TPU).  A doc scores s = sum_t qw[t] * sum_l dw[l]*[dt[l] == qt[t]] (-1
// terms inert; no positive mass -> -inf, id -1), summed over l, then t, in
// order with rounded, uncontracted adds and multiplies, so the scores are
// bit-equal to the plain version's.
//
// On the TPU one grid walks the postings tiles in order and merges each
// tile into a running [k] buffer: K rounds of "the tile's best replaces
// the buffer's argmin (its lowest slot among equal minima) when strictly
// greater", then a stable sort.  The answer depends on the tile boundaries
// and on that exchange (it is not the exact top-k by score, then row:
// lexical scores tie all the time), so it is replayed here, in one launch:
//
//   - hit-driven scoring: each CTA first puts the batch's B x T query terms
//     into a shared-memory hash table (term -> list of (query, t); -1 terms
//     stay out, a weight of 0 is still a term) and a 65,536-bit filter of
//     their hashes.  A posting whose filter bit is clear (nearly all of
//     them: at most 256 of the bits are set) costs a hash and one
//     shared-memory load, whatever B is; the others look the term up, and
//     each match (posting, (query, t)) is listed.  A round without matches
//     ends there;
//   - a persistent grid (two CTAs per SM); CTA c takes the tile_n-row tiles
//     c, c + G, c + 2G, ... (the reference's tiles) kRound at a time.  Each
//     thread loads kBatch 16-byte units of the round's terms at once into
//     registers (4-byte units where the tiles do not start on 16-byte
//     boundaries; the last unit of a tail tile word by word, never past N)
//     and probes the terms it loaded: no staging and no barrier per tile,
//     a whole round in flight at the hybrid path's shape, the first loads
//     issued before the table is built.  Only the terms are streamed;
//   - the fast path: a round's matches are appended to one list in global
//     memory (kList entries) and the CTA is done.  The last CTA to arrive
//     (an atomic ticket, reset by it) scores them, all rows' loads at once
//     (the query's first (l, t) hit in a row scores the row, in full and in
//     the reference's order; the others drop out), groups the finite ones
//     by query and orders each group by (tile asc, score desc, row asc):
//     the order in which the reference's tiles offer them.  A tile may
//     offer more than its top k: once k of a tile's candidates have
//     entered, the buffer's minimum is the k-th, so the rest cannot;
//   - the slow path, for a round whose matches overflow its list or find
//     the global list full: the CTA scores its matches (as above), and
//     each (tile, query) writes its top-k by (score desc, column asc) from
//     the ranks of its hits, padded with -inf to k, and sets its bit in the
//     query's bitmap of tiles; a (tile, query) that lost a match scores
//     every row of the tile in full and takes its top-k by warp argmax
//     rounds;
//   - the last CTA then replays, one warp per query, the exchange over the
//     query's candidates in tile order (its ordered list, merged with the
//     bitmap's tiles when any round took the slow path, the bits cleared as
//     they are read), 32 candidates at a time: the first k finite ones fill
//     the empty slots in order (the buffer's minimum is its lowest empty
//     slot until then), and each later one greater than the minimum, found
//     by a warp ballot, replaces it (the minimum and its lowest slot by one
//     redux.sync and a ballot).  Last, a stable sort by value desc over
//     slot order; ids of -inf slots are -1.
//
// What bounds it on an H100: bytes, the terms stream (N*L*4 bytes: 10 MB
// at N=500,000, L=5, about 3 us at 3.35 TB/s) and the weights of the rows
// that hit; the probes are N*L, not B*T*L compares a row.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

using has_kernels::kFull;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTableBits = 10;
constexpr int kTable = 1 << kTableBits;   // hash slots
constexpr int kFilterBits = 16;           // bits of the filter
constexpr int kEmpty = INT_MIN;           // an empty slot's key
constexpr int kEntries = 256;             // (query, t) pairs a launch holds
constexpr int kQueries = 128;             // queries a launch holds
constexpr int kHits = 512;                // a round's list of matches
constexpr int kRound = 4;                 // tiles a CTA takes at once
constexpr int kBatch = 5;                 // units a thread loads at once
constexpr int kList = 2048;               // matches handed to the last CTA
constexpr int kMaxL = 8;                  // row widths held in registers

// The front of the dynamic shared memory.
struct Fixed {
  unsigned filter[(1 << kFilterBits) / 32];   // the query terms' hash bits
  int key[kTable];        // a slot's term, kEmpty if none
  int head[kTable];       // the slot's first (query, t) entry
  int next[kEntries];     // the next entry of the same term
  int qt[kEntries];       // query terms [B, T]
  float qw[kEntries];     // query weights [B, T]
  int hk[kHits];          // the round's matches: round tile << 30 |
                          //   entry << 22 | posting; on the slow path
                          //   then round tile << 23 | query << 16 | column
  float hv[kHits];        //   and the score (-inf: none)
  int cnt[kQueries];      // the last CTA: finite matches a query
  int off[kQueries + 4];  // where each query's group starts; off[B]: all
  int cur[kQueries];
  unsigned ovf[kRound * kQueries / 32];   // (tile, query)s that lost one
  int n_hits;
  int flag;
  int pad[2];
};

// Stamps for lexical_score_probe.py, compiled in only with
// -DLEXICAL_TRACE: thread 0 of each CTA records %globaltimer at its entry
// (mark 0), after the table (1), after its first round's probe loop (9)
// and after its last round (3), and sums over its rounds the probes (5)
// and the slow path's selection (6); the last CTA also stamps after the
// ticket (4), after scoring the list (11), after ordering it (12), after
// query 0's replay (13) and at its end (8) (kTraceMarks a CTA, for the
// first kTraceCtas CTAs).
#ifdef LEXICAL_TRACE
constexpr int kTraceMarks = 14;
constexpr int kTraceCtas = 1024;
__device__ unsigned long long g_trace[kTraceCtas * kTraceMarks];
__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void trace(int mark, unsigned long long t) {
  if (threadIdx.x == 0 && blockIdx.x < kTraceCtas)
    g_trace[blockIdx.x * kTraceMarks + mark] = t;
}
#else
__device__ __forceinline__ unsigned long long now() { return 0; }
__device__ __forceinline__ void trace(int, unsigned long long) {}
#endif

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// The last CTA's list: its matches scored (a*), then grouped by query
// (g*), then ordered in each group (a* again, aq then the tile).
struct List {
  float av[kList];
  int ar[kList];          // their rows
  int aq[kList];          // their queries (-1: no score)
  float gv[kList];
  int gr[kList];
  int gt[kList];          // their tiles
};

// Dynamic shared memory: the fixed part, the overflow path's scores, then
// the last CTA's list.
__host__ __device__ constexpr int smem_bytes(int tile_n) {
  return static_cast<int>(sizeof(Fixed)) + 4 * round4(tile_n) +
         static_cast<int>(sizeof(List));
}

__device__ __forceinline__ unsigned hash(int term) {
  return static_cast<unsigned>(term) * 0x9e3779b1u;
}
__device__ __forceinline__ int slot_of(int term) {
  return static_cast<int>(hash(term) >> (32 - kTableBits));
}
// True if term's filter bit is set (the term may be a query term).
__device__ __forceinline__ bool maybe(const Fixed& f, int term) {
  const unsigned h = hash(term) >> (32 - kFilterBits);
  return (f.filter[h >> 5] >> (h & 31)) & 1u;
}

// The slot of `term`, or -1 (a negative term is never in the table).
__device__ __forceinline__ int find(const Fixed& f, int term) {
  int s = slot_of(term);
  while (true) {
    const int key = f.key[s];
    if (key == term && term >= 0) return s;
    if (key == kEmpty) return -1;
    s = (s + 1) & (kTable - 1);
  }
}

// Unit u of a tile's `words` terms at p: words 4u..4u+3 (Wide) or word u,
// -1 where the tile has none.  A wide unit is one 16-byte load unless it
// is the tile's last and partial.
template <bool Wide>
__device__ __forceinline__ int4 load_unit(const int* __restrict__ p,
                                          int words, int u) {
  int4 v = make_int4(-1, -1, -1, -1);
  if (!Wide) {
    if (u < words) v.x = __ldg(p + u);
  } else if (4 * u + 4 <= words) {
    v = __ldg(reinterpret_cast<const int4*>(p) + u);
  } else if (4 * u < words) {
    v.x = __ldg(p + 4 * u);
    if (4 * u + 1 < words) v.y = __ldg(p + 4 * u + 1);
    if (4 * u + 2 < words) v.z = __ldg(p + 4 * u + 2);
  }
  return v;
}

// A row's terms and weights (in shared or global memory): in registers
// for L <= kMaxL (all loads at once), read at each use otherwise.
struct Row {
  int t[kMaxL];
  float w[kMaxL];
  const int* gt;
  const float* gw;
  int L;
  __device__ __forceinline__ Row(const int* terms, const float* weights,
                                 int L_)
      : gt(terms), gw(weights), L(L_) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l) {
      t[l] = l < L && L <= kMaxL ? gt[l] : -1;
      w[l] = l < L && L <= kMaxL ? gw[l] : 0.f;
    }
  }
};

// Calls fn(l, term, weight) for l = 0..L-1, in order.
template <class Fn>
__device__ __forceinline__ void for_each(const Row& row, Fn fn) {
  if (row.L <= kMaxL) {
#pragma unroll
    for (int l = 0; l < kMaxL; ++l)
      if (l < row.L) fn(l, row.t[l], row.w[l]);
  } else {
    for (int l = 0; l < row.L; ++l) fn(l, row.gt[l], row.gw[l]);
  }
}

// True if (l, t) is query qtb's first hit in the row, in (l, t) order.
__device__ __forceinline__ bool first_hit(const int* qtb, int T,
                                          const Row& row, int l, int t) {
  bool first = true;
  for_each(row, [&](int l2, int d2, float) {
    const int tmax = l2 < l ? T : (l2 == l ? t : 0);
    for (int t2 = 0; t2 < tmax; ++t2)
      if (qtb[t2] >= 0 && qtb[t2] == d2) first = false;
  });
  return first;
}

// A row's score for one query, in the reference's order (> 0 or no match).
__device__ __forceinline__ float score(const int* qtb, const float* qwb,
                                       int T, const Row& row) {
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const int qt = qtb[t];
    float m = 0.f;
    for_each(row, [&](int, int dt, float dw) {
      m = __fadd_rn(m, (dt == qt && dt >= 0 && qt >= 0) ? dw : 0.f);
    });
    acc = __fadd_rn(acc, __fmul_rn(qwb[t], m));
  }
  return acc;
}

// Term `term` at posting p of round tile r: list an entry for each
// (query, t) it matches, or flag the (tile, query) when the list is full.
__device__ __forceinline__ void on_term(Fixed& f, int term, int p, int r,
                                        int T) {
  const int slot = find(f, term);
  if (slot < 0) return;
  for (int e = f.head[slot]; e >= 0; e = f.next[e]) {
    const int pos = atomicAdd(&f.n_hits, 1);
    if (pos < kHits) {
      f.hk[pos] = static_cast<int>(static_cast<unsigned>(r) << 30 |
                                   static_cast<unsigned>(e) << 22 |
                                   static_cast<unsigned>(p));
    } else {
      const int qb = e / T;
      atomicOr(&f.ovf[(r * kQueries + qb) >> 5], 1u << (qb & 31));
    }
  }
}

// True in every thread of the CTA that arrives last at `ticket` out of
// `members` CTAs; that CTA resets the ticket to 0.  One thread releases
// the CTA's global writes (ordered before it by the barrier) with its
// atomic add, and the last CTA acquires everyone's with the same add, as
// CUTLASS's barrier does: no fence in every thread.
__device__ __forceinline__ bool arrive_last(int* ticket, int members,
                                            int* flag_s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    const bool last = old == members - 1;
    if (last) atomicExch(ticket, 0);
    *flag_s = last;
  }
  __syncthreads();
  return *flag_s != 0;
}

// Index of the n-th (1-based, n <= popc(mask)) set bit of mask.
__device__ __forceinline__ int nth_bit(unsigned mask, int n) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__popc(mask & ((1u << (pos + step)) - 1u)) < n) pos += step;
  return pos;
}

// The running [k] buffer of the reference's exchange, one slot a lane
// (lanes < k): a candidate replaces the buffer's minimum (its lowest slot
// among equal minima) when strictly greater.  feed() takes 32 candidates
// in lane order (-inf: none).
struct Buffer {
  float v = -INFINITY;
  int id = -1;
  int filled = 0;        // slots 0..filled-1 hold finite values
  float mn = -INFINITY;  // once full: the minimum and its lowest slot
  int mslot = 0;
  int k, lane;

  __device__ __forceinline__ Buffer(int k_, int lane_) : k(k_), lane(lane_) {}

  __device__ __forceinline__ void remin() {
    const unsigned key = lane < k ? has_kernels::order_bits(v) : ~0u;
    const unsigned m = __reduce_min_sync(kFull, key);
    mslot = __ffs(__ballot_sync(kFull, key == m)) - 1;
    mn = has_kernels::from_order_bits(m);
  }

  __device__ __forceinline__ void feed(float c, int cid) {
    unsigned todo;
    if (filled < k) {
      // the first finite candidates fill the empty slots in order (the
      // minimum is the lowest empty slot until the buffer is full)
      const unsigned fin = __ballot_sync(kFull, c > -INFINITY);
      const int take = min(k - filled, __popc(fin));
      const bool mine = lane >= filled && lane < filled + take;
      const int src = nth_bit(fin, mine ? lane - filled + 1 : 1);
      const float nv = __shfl_sync(kFull, c, src);
      const int nid = __shfl_sync(kFull, cid, src);
      if (mine) {
        v = nv;
        id = nid;
      }
      filled += take;
      if (filled < k) return;
      remin();
      todo = __ballot_sync(kFull, c > mn) &
             ~((2u << nth_bit(fin, take)) - 1u);   // the ones after them
    } else {
      todo = __ballot_sync(kFull, c > mn);
    }
    while (todo) {
      // the next candidate greater than the minimum replaces it
      const int j = __ffs(todo) - 1;
      const float cj = __shfl_sync(kFull, c, j);
      const int idj = __shfl_sync(kFull, cid, j);
      if (lane == mslot) {
        v = cj;
        id = idj;
      }
      remin();
      todo &= ~((2u << j) - 1u);               // the candidates after j
      todo &= __ballot_sync(kFull, c > mn);
    }
  }
};

template <bool Wide>
__global__ void __launch_bounds__(kThreads, 2)
lexical_kernel(const int* __restrict__ q_terms,
               const float* __restrict__ q_weights,
               const int* __restrict__ doc_terms,
               const float* __restrict__ doc_weights, int* tickets,
               int2* list, float* cand_v, int* cand_r,
               float* __restrict__ out_vals, int* __restrict__ out_ids, int B,
               int T, int N, int L, int tile_n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  trace(0, now());
  trace(4, 0);
  unsigned long long t_probe = 0, t_select = 0;
  Fixed& f = *reinterpret_cast<Fixed*>(smem);
  float* sc = reinterpret_cast<float*>(smem + sizeof(Fixed));
  List& lst = *reinterpret_cast<List*>(smem + sizeof(Fixed) +
                                       4 * round4(tile_n));
  int* const ticket = tickets;
  int* const reserved = tickets + 1;     // list entries asked for
  int* const written = tickets + 2;      // list entries written: [0, n)
  int* const slow = tickets + 3;         // a round took the slow path
  unsigned* const bitmap = reinterpret_cast<unsigned*>(tickets + 4);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = gridDim.x;
  const int n_tiles = (N + tile_n - 1) / tile_n;
  const int n_words = (n_tiles + 31) / 32;
  const int BT = B * T;
  const int units = Wide ? tile_n * L / 4 : tile_n * L;   // a full tile's

  // a round's tile r and the words of its terms
  auto tile_words = [&](int first, int r, const int** src) {
    const int tile = first + r * G;
    if (r >= kRound || tile >= n_tiles) return 0;
    const long long row0 = static_cast<long long>(tile) * tile_n;
    *src = doc_terms + row0 * L;
    return static_cast<int>(min(static_cast<long long>(tile_n), N - row0)) *
           L;
  };
  // a thread loads units j0 + i * kThreads, i < kBatch, of the round (unit
  // j is unit j % units of tile j / units) into registers, at once
  int4 v[kBatch];
  auto load = [&](int first, int j0) {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int j = j0 + i * kThreads;
      const int r = j / units;
      const int* src = nullptr;
      const int words = tile_words(first, r, &src);
      v[i] = load_unit<Wide>(src, words, j - r * units);
    }
  };
  // the query terms' loads go out first, then the first round's terms
  // (before the table is built)
  const int qt_e = tid < BT ? q_terms[tid] : -1;
  const float qw_e = tid < BT ? q_weights[tid] : 0.f;
  asm volatile("" ::: "memory");
  load(blockIdx.x, tid);
  // the query terms' hash table and filter
  for (int s = tid; s < kTable; s += kThreads) f.key[s] = kEmpty;
  for (int w = tid; w < (1 << kFilterBits) / 32; w += kThreads)
    f.filter[w] = 0u;
  if (tid < BT) {
    f.qt[tid] = qt_e;
    f.qw[tid] = qw_e;
  }
  if (tid < kRound * kQueries / 32) f.ovf[tid] = 0u;
  if (tid == 0) f.n_hits = 0;
  __syncthreads();
  for (int e = tid; e < BT; e += kThreads) {
    const int term = f.qt[e];
    if (term < 0) continue;
    const unsigned h = hash(term) >> (32 - kFilterBits);
    atomicOr(&f.filter[h >> 5], 1u << (h & 31));
    int s = slot_of(term);
    while (true) {
      const int prev = atomicCAS(&f.key[s], kEmpty, term);
      if (prev == kEmpty) f.head[s] = -1;   // this thread took the slot
      if (prev == kEmpty || prev == term) break;
      s = (s + 1) & (kTable - 1);
    }
  }
  __syncthreads();
  for (int e = tid; e < BT; e += kThreads) {
    const int term = f.qt[e];
    if (term >= 0) f.next[e] = atomicExch(&f.head[find(f, term)], e);
  }
  __syncthreads();
  trace(1, now());

  for (int first = blockIdx.x; first < n_tiles; first += kRound * G) {
    const unsigned long long t0 = now();
    // probes: kBatch units at once (all of a round's at the hybrid path's
    // shape); a term whose filter bit is clear goes no further
    for (int j0 = tid; j0 < kRound * units; j0 += kBatch * kThreads) {
      if (first != static_cast<int>(blockIdx.x) || j0 != tid) load(first, j0);
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = j0 + i * kThreads;
        const int r = j / units;
        const int p = Wide ? 4 * (j - r * units) : j - r * units;
        if (maybe(f, v[i].x)) on_term(f, v[i].x, p, r, T);
        if (Wide) {
          if (maybe(f, v[i].y)) on_term(f, v[i].y, p + 1, r, T);
          if (maybe(f, v[i].z)) on_term(f, v[i].z, p + 2, r, T);
          if (maybe(f, v[i].w)) on_term(f, v[i].w, p + 3, r, T);
        }
      }
    }
    if (first == static_cast<int>(blockIdx.x)) trace(9, now());
    __syncthreads();
    const int listed = f.n_hits;              // > kHits: some were lost
    if (listed == 0) {                        // no match: the round is done
      __syncthreads();                        // all have read n_hits
      t_probe += now() - t0;
      continue;
    }
    // the fast path: the round's matches go to the last CTA's list
    if (tid == 0) {
      int pos = -1;
      if (listed <= kHits) {
        pos = atomicAdd(reserved, listed);
        if (pos + listed <= kList)
          atomicAdd(written, listed);
        else
          pos = -1;                           // the list is full
      }
      if (pos < 0) atomicExch(slow, 1);
      f.flag = pos;
    }
    __syncthreads();
    const int pos = f.flag;
    if (pos >= 0) {
      for (int h = tid; h < listed; h += kThreads) {
        const unsigned key = static_cast<unsigned>(f.hk[h]);
        const int r = static_cast<int>(key >> 30);
        const int e = static_cast<int>((key >> 22) & 0xff);
        const int p = static_cast<int>(key & 0x3fffff);
        const int col = p / L;
        const int row = (first + r * G) * tile_n + col;
        list[pos + h] = make_int2(row, e | (p - col * L) << 8);
        // the last CTA reads the row's weights: bring them to L2 now
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            doc_weights + static_cast<long long>(row) * L));
      }
      __syncthreads();                        // all have read n_hits, flag
      if (tid == 0) f.n_hits = 0;
      __syncthreads();
      t_probe += now() - t0;
      continue;
    }
    // the slow path: each listed (row, query, t) is scored here, by the
    // query's first hit in the row, all rows' loads at once
    const int n_hits = min(listed, kHits);
    for (int h = tid; h < n_hits; h += kThreads) {
      const unsigned key = static_cast<unsigned>(f.hk[h]);
      const int r = static_cast<int>(key >> 30);
      const int e = static_cast<int>((key >> 22) & 0xff);
      const int p = static_cast<int>(key & 0x3fffff);
      const int qb = e / T;
      const int col = p / L;
      const long long at =
          (static_cast<long long>(first + r * G) * tile_n + col) * L;
      const Row row(doc_terms + at, doc_weights + at, L);
      float s = -INFINITY;
      if (!((f.ovf[(r * kQueries + qb) >> 5] >> (qb & 31)) & 1u) &&
          first_hit(f.qt + qb * T, T, row, p - col * L, e - qb * T)) {
        const float a = score(f.qt + qb * T, f.qw + qb * T, T, row);
        if (a > 0.f) s = a;
      }
      f.hv[h] = s;
      f.hk[h] = (r << 23) | (qb << 16) | col;
    }
    __syncthreads();
    const unsigned long long t1 = now();
    t_probe += t1 - t0;

    // hits -> each (tile, query)'s top-k by (score desc, column asc)
    for (int h = tid; h < n_hits; h += kThreads) {
      const float c = f.hv[h];
      if (!(c > -INFINITY)) continue;         // no score, or a lost tile
      const int key = f.hk[h];
      const int r = key >> 23;
      const int qb = (key >> 16) & (kQueries - 1);
      const int col = key & 0xffff;
      int rank = 0, cnt = 0;
      for (int j = 0; j < n_hits; ++j) {
        const int kj = f.hk[j];
        const float cj = f.hv[j];
        if ((kj >> 16) != (key >> 16) || !(cj > -INFINITY)) continue;
        ++cnt;
        rank += (cj > c || (cj == c && (kj & 0xffff) < col)) ? 1 : 0;
      }
      const int tile = first + r * G;
      const size_t cell = static_cast<size_t>(qb) * n_tiles + tile;
      if (rank < k) {
        cand_v[cell * k + rank] = c;
        cand_r[cell * k + rank] = tile * tile_n + col;
      }
      if (rank == 0) {
        for (int j = cnt; j < k; ++j) cand_v[cell * k + j] = -INFINITY;
        atomicOr(bitmap + static_cast<size_t>(qb) * n_words + tile / 32,
                 1u << (tile & 31));
      }
    }
    // overflow: score a tile in full for each (tile, query) that lost one
    for (int w = 0; listed > kHits && w < kRound * kQueries / 32; ++w) {
      unsigned bits = f.ovf[w];
      while (bits) {
        const int r = w / (kQueries / 32);
        const int qb = (w % (kQueries / 32)) * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const int tile = first + r * G;
        const long long row0 = static_cast<long long>(tile) * tile_n;
        const int rows = static_cast<int>(
            min(static_cast<long long>(tile_n), N - row0));
        for (int c = tid; c < tile_n; c += kThreads) {
          float s = -INFINITY;
          if (c < rows) {
            const long long at = (row0 + c) * L;
            const float a = score(f.qt + qb * T, f.qw + qb * T, T,
                                  Row(doc_terms + at, doc_weights + at, L));
            if (a > 0.f) s = a;
          }
          sc[c] = s;
        }
        __syncthreads();
        if (warp == 0) {
          // the reference's rounds: best (score desc, column asc), remove
          const size_t cell = static_cast<size_t>(qb) * n_tiles + tile;
          int j = 0;
          for (; j < k; ++j) {
            float bv = -INFINITY;
            int bk = INT_MAX;
            for (int c = lane; c < tile_n; c += 32)
              if (has_kernels::better(sc[c], c, bv, bk)) {
                bv = sc[c];
                bk = c;
              }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              const float ov = __shfl_xor_sync(kFull, bv, o);
              const int ok = __shfl_xor_sync(kFull, bk, o);
              if (has_kernels::better(ov, ok, bv, bk)) {
                bv = ov;
                bk = ok;
              }
            }
            if (!(bv > -INFINITY)) break;     // the tile has no more
            if (lane == 0) {
              cand_v[cell * k + j] = bv;
              cand_r[cell * k + j] = tile * tile_n + bk;
              sc[bk] = -INFINITY;
            }
            __syncwarp();
          }
          if (lane == 0 && j > 0) {
            for (int jj = j; jj < k; ++jj) cand_v[cell * k + jj] = -INFINITY;
            atomicOr(bitmap + static_cast<size_t>(qb) * n_words + tile / 32,
                     1u << (tile & 31));
          }
        }
        __syncthreads();                      // sc is reused
      }
    }
    __syncthreads();                          // the list and the flags
    t_select += now() - t1;
    if (tid == 0) f.n_hits = 0;
    if (tid < kRound * kQueries / 32) f.ovf[tid] = 0u;
    __syncthreads();
  }
  trace(3, now());
  trace(5, t_probe);
  trace(6, t_select);

  if (!arrive_last(ticket, G, &f.flag)) return;
  trace(4, now());
  // the last CTA.  1: score the list's matches, all rows' loads at once
  const int n_list = __ldcg(written);
  const bool slow_tiles = __ldcg(slow) != 0;
  for (int q = tid; q < B; q += kThreads) f.cnt[q] = 0;
  __syncthreads();
  if (tid == 0) {                             // zero for the next call
    *reserved = 0;
    *written = 0;
    *slow = 0;
  }
  for (int h = tid; h < n_list; h += kThreads) {
    const int2 m = __ldcg(list + h);
    const int e = m.y & 0xff;
    const int qb = e / T;
    const long long at = static_cast<long long>(m.x) * L;
    const Row row(doc_terms + at, doc_weights + at, L);
    float s = -INFINITY;
    if (first_hit(f.qt + qb * T, T, row, m.y >> 8, e - qb * T)) {
      const float a = score(f.qt + qb * T, f.qw + qb * T, T, row);
      if (a > 0.f) s = a;
    }
    lst.av[h] = s;
    lst.ar[h] = m.x;
    lst.aq[h] = s > -INFINITY ? qb : -1;
    if (s > -INFINITY) atomicAdd(&f.cnt[qb], 1);
  }
  __syncthreads();
  trace(11, now());
  // 2: where each query's group of finite matches goes
  if (warp == 0) {
    int c[kQueries / 32];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kQueries / 32; ++i) {
      const int q = lane * (kQueries / 32) + i;
      c[i] = q < B ? f.cnt[q] : 0;
      sum += c[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    int base = incl - sum;
#pragma unroll
    for (int i = 0; i < kQueries / 32; ++i) {
      const int q = lane * (kQueries / 32) + i;
      if (q < B) f.off[q] = f.cur[q] = base;
      base += c[i];
    }
    if (lane == 31) f.off[B] = incl;
  }
  __syncthreads();
  // 3: group the matches by query, then order each group by (tile asc,
  // score desc, row asc)
  for (int h = tid; h < n_list; h += kThreads) {
    const int qb = lst.aq[h];
    if (qb < 0) continue;
    const int at = atomicAdd(&f.cur[qb], 1);
    lst.gv[at] = lst.av[h];
    lst.gr[at] = lst.ar[h];
    lst.gt[at] = lst.ar[h] / tile_n;
  }
  __syncthreads();
  const int total = f.off[B];
  for (int i = tid; i < total; i += kThreads) {
    int lo = 0, hi = B - 1;                 // the last group from <= i
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (f.off[mid] <= i) lo = mid; else hi = mid - 1;
    }
    const int g0 = f.off[lo], g1 = f.off[lo + 1];
    const float ci = lst.gv[i];
    const int ri = lst.gr[i];
    const int ti = lst.gt[i];
    int rank = 0;
    for (int j = g0; j < g1; ++j) {
      const float cj = lst.gv[j];
      const int rj = lst.gr[j];
      const int tj = lst.gt[j];
      rank +=
          (tj < ti || (tj == ti && (cj > ci || (cj == ci && rj < ri))))
              ? 1 : 0;
    }
    lst.av[g0 + rank] = ci;
    lst.ar[g0 + rank] = ri;
    lst.aq[g0 + rank] = ti;                 // from here: the tile
  }
  __syncthreads();
  trace(12, now());
  // 4: one warp per query replays the exchange in tile order: the list's
  // matches, and the candidates of the tiles that took the slow path
  for (int qb = warp; qb < B; qb += kWarps) {
    Buffer buf(k, lane);
    int fo = f.off[qb];
    const int fe = f.off[qb + 1];
    auto listed_before = [&](int tile_lim) {  // the list's, tile < tile_lim
      while (fo < fe) {
        const int e = fo + lane;
        const bool in = e < fe && lst.aq[e] < tile_lim;
        const int n = __popc(__ballot_sync(kFull, in));
        if (n == 0) break;
        buf.feed(in ? lst.av[e] : -INFINITY, in ? lst.ar[e] : -1);
        fo += n;
      }
    };
    if (slow_tiles) {
      unsigned* bm = bitmap + static_cast<size_t>(qb) * n_words;
      for (int w0 = 0; w0 < n_words; w0 += 32) {
        const int w = w0 + lane;
        const unsigned word = w < n_words ? __ldcg(bm + w) : 0u;
        if (word) bm[w] = 0u;                 // zero for the next call
        unsigned nz = __ballot_sync(kFull, word != 0u);
        while (nz) {
          const int src = __ffs(nz) - 1;
          nz &= nz - 1;
          unsigned bits = __shfl_sync(kFull, word, src);
          while (bits) {
            const int tile = (w0 + src) * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            listed_before(tile);
            const size_t at =
                (static_cast<size_t>(qb) * n_tiles + tile) * k + lane;
            buf.feed(lane < k ? __ldcg(cand_v + at) : -INFINITY,
                     lane < k ? __ldcg(cand_r + at) : -1);
          }
        }
      }
    }
    listed_before(INT_MAX);
    // stable sort by value desc over slot order
    int rank = 0;
    for (int i = 0; i < k; ++i) {
      const float vi = __shfl_sync(kFull, buf.v, i);
      rank += (vi > buf.v || (vi == buf.v && i < lane)) ? 1 : 0;
    }
    if (lane < k) {
      out_vals[static_cast<size_t>(qb) * k + rank] = buf.v;
      out_ids[static_cast<size_t>(qb) * k + rank] =
          buf.v > -INFINITY ? buf.id : -1;
    }
    if (qb == 0) trace(13, now());
  }
  __syncthreads();
  trace(8, now());
}

template <bool Wide>
cudaError_t launch(const int* q_terms, const float* q_weights,
                   const int* doc_terms, const float* doc_weights,
                   int* tickets, int2* list, float* cand_v, int* cand_r,
                   float* out_vals, int* out_ids, int B, int T, int N, int L,
                   int tile_n, int k, int ctas, cudaStream_t st) {
  const size_t smem = smem_bytes(tile_n);
  cudaError_t err = has_kernels::allow_smem(lexical_kernel<Wide>, smem);
  if (err != cudaSuccess) return err;
  lexical_kernel<Wide><<<ctas, kThreads, smem, st>>>(
      q_terms, q_weights, doc_terms, doc_weights, tickets, list, cand_v,
      cand_r, out_vals, out_ids, B, T, N, L, tile_n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for tile_n-row tiles.
int has_lexical_smem(int tile_n) { return smem_bytes(tile_n); }

// q_terms / q_weights [B, T] (B <= 128, B*T <= 256), doc_terms /
// doc_weights [N, L] (tile_n < 65536, tile_n * L < 2^22); out_vals /
// out_ids [B, k], k <= 32.  tickets: the ticket, the list's three counts,
// then B * ceil(n_tiles / 32) bitmap words, all 0 (and left 0); words: the
// list (kList int2), then candidate values and rows, [B, n_tiles, k] each.
// `ctas` persistent CTAs.
int has_lexical_score(const int* q_terms, const float* q_weights,
                      const int* doc_terms, const float* doc_weights,
                      void* tickets, void* words, float* out_vals,
                      int* out_ids, int B, int T, int N, int L, int tile_n,
                      int k, int ctas, void* stream) {
  if (B > kQueries || B * T > kEntries || k < 1 || k > 32 ||
      tile_n > 0xffff || static_cast<long long>(tile_n) * L >= (1 << 22))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cells = static_cast<size_t>(B) * ((N + tile_n - 1) / tile_n);
  int2* list = static_cast<int2*>(words);
  float* cand_v = reinterpret_cast<float*>(list + kList);
  int* cand_r = reinterpret_cast<int*>(cand_v + cells * k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte units when every tile starts on a 16-byte boundary
  const bool wide = reinterpret_cast<uintptr_t>(doc_terms) % 16 == 0 &&
                    (tile_n * L) % 4 == 0;
  int* t = static_cast<int*>(tickets);
  return static_cast<int>(
      wide ? launch<true>(q_terms, q_weights, doc_terms, doc_weights, t,
                          list, cand_v, cand_r, out_vals, out_ids, B, T, N,
                          L, tile_n, k, ctas, st)
           : launch<false>(q_terms, q_weights, doc_terms, doc_weights, t,
                           list, cand_v, cand_r, out_vals, out_ids, B, T, N,
                           L, tile_n, k, ctas, st));
}

#ifdef LEXICAL_TRACE
// The stamps of the last traced launch: n words into host memory.
int has_lexical_trace(unsigned long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, n * 8));
}
#endif

}  // extern "C"
