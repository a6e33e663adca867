// The auction's bidding rounds over per-pod bid shortlists, for Hopper.
//
// Replaces the JAX package's auction_assign_shortlist
// (minisched_tpu/ops/bid_select.py:76-210: lax.top_k at :107, the lax.cond
// repair at :164, the lax.while_loop at :205; not a Pallas kernel), bit
// for bit. Once per launch every pod's K best noise-folded scores are
// selected (lax.top_k's set: value by total order, lowest column first
// among ties, +0.0 above -0.0; kth is the K-th value). Each round then
// reduces an active pod's K candidates (folded score less the open price)
// to its best m, the lowest tied candidate column, and the best v2 over the
// other candidates. The round is certified when (m > kth and v2 >= kth)
// or kth <= NEG: the dense round's bid, proven inside the shortlist.
// Otherwise the block scans the pod's full row as the dense kernel does and
// marks the pod repaired (an OR over rounds; an active pod whose
// candidates are all closed while kth > NEG counts too). The rest of the
// round is the dense kernel's: auction_rounds.cuh.
//
// Bound. The selection reads every score row once, 218 MB at bench-50k
// (1024 x 53248), about 65 us at 3.35 TB/s; a round then reads the active
// pods' candidates, 8 bytes per candidate (1 MB at K = 128), and a repaired
// pod's full row. The rounds are bound by their grid barriers and the
// round trips between them, not by bytes.
//
// Selection: the threshold design of csrc/shortlist_select.cu, for a set
// without order. One block a row, the row's folded keys kept in dynamic
// shared memory (4N bytes beside the list: rows up to about 54,000
// columns; a wider row folds its scores again, from L2, in each pass):
//
//   pass 1  fold each score once (float4 loads, four in flight per
//           thread), store its total-order key, keep each thread's largest;
//   L       the K-th largest of the thread maxima, by a bisection of
//           __syncthreads_count below the bits all maxima share. At least
//           K keys are >= L, so L <= the K-th key, and the keys above L are
//           few (about K on a diverse row);
//   pass 2  compact every key >= L into a list in shared memory, counting
//           those above L and those equal to it;
//   rank    when the list holds them all (at most kCap), each entry's rank
//           in (key descending, column ascending) is the number of entries
//           above it, one pass over the list per entry; ranks below K are
//           the set, written in lax.top_k's order, and rank K-1 is kth.
//
// The order in (key, column) is lax.top_k's, ties included, and keys are
// integers: no float equality joins +0.0 and -0.0. When the ties at L
// overflow the list, the list is rebuilt from the keys above L alone: if
// at least K are there they are ranked; else all of them are taken, kth
// is L, and the lowest columns equal to L fill the set in one ordered
// walk of the row (ballots and a per-warp prefix, stopping once enough are
// taken). K = N takes every column, kth the row's least key. When even
// the keys above L overflow the list, the row takes the exact path: an
// MSB-first radix select (four 8-bit histogram passes for kth, then a
// collection of the keys above it and the lowest columns at it).
//
// Rounds: a certified pod bids with one warp (its candidates spread over
// the lanes, no block barrier), for K <= kWarpK; the uncertified ones go
// to the block, one after another, for their full rows (each thread
// keeps four 16-byte loads of scores and of open prices in flight).
// Wider shortlists bid with the whole block, one pod after another. The
// block finds its marked pods kThreads entries a step, not one (a batch
// past the shared-memory wall has ~10,000 pods a block).
//
// Shared memory: each row's keys (the selection's cache) come first, then
// the block's Pods where they fit beside them; a batch too large for that
// keeps its Pods in device memory (the kernel's kDevice instance).
// bid_auction_layout(P, N) reports the choice.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/auction_kernel_timing.py,
// PERF.md), in turns with the radix-selection kernel it replaces: about
// 0.263 against 1.08 ms at 1024 x 53248 (the selection 0.226 against
// 1.00 ms), 0.114 against 0.195 ms at 1024 x 4096 (the selection 0.063
// against 0.106 ms, a round 12.7 us against 22).
//
// Interface: as csrc/auction.cu, plus K (1 <= K <= N) and the (P,)
// repaired output; bid_auction_scratch_bytes(P, N, K) bytes of scratch.

#include "auction_rounds.cuh"

using namespace auction;

namespace {

constexpr int kCap = 1024;                  // list entries
constexpr size_t kListBytes = 8ull * kCap;  // (key << 32 | ~column) each
constexpr int kWarpK = 256;                 // widest shortlist a warp bids
constexpr unsigned long long kRepair = ~0ull;  // no bid key is all ones

__device__ __forceinline__ uint32_t lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The block's Top2, returned to every thread.
__device__ Top2 block_top2(Top2 t) {
  __shared__ Top2 warp_t[kWarps];
  __shared__ Top2 result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t = warp_top2(t);
  if (lane == 0) warp_t[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = warp_top2(lane < kWarps ? warp_t[lane] : top2_empty());
    if (lane == 0) result = t;
  }
  __syncthreads();
  t = result;
  __syncthreads();
  return t;
}

// The dense round's Top2 of pod `row` over its whole row, for a repair
// (every thread of the block calls it; every thread gets the result):
// each thread keeps kRepairDepth 16-byte loads of scores and as many of
// open prices in flight.
__device__ Top2 dense_top2(const Params& p, int row) {
  constexpr int kRepairDepth = 4;
  Top2 t = top2_empty();
  const float* srow = p.scores + static_cast<size_t>(row) * p.N;
  const uint32_t hb = p.seed + static_cast<uint32_t>(row) * kGolden;
  if ((p.N & 3) == 0 && (reinterpret_cast<uintptr_t>(srow) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    const float4* o4 = reinterpret_cast<const float4*>(p.open_price);
    const int n4 = p.N >> 2;
    for (int base = threadIdx.x; base < n4;
         base += kRepairDepth * kThreads) {
      float4 v[kRepairDepth], o[kRepairDepth];
#pragma unroll
      for (int k = 0; k < kRepairDepth; ++k) {
        const int q = base + k * kThreads;
        if (q < n4) {
          v[k] = __ldg(s4 + q);
          o[k] = __ldcg(o4 + q);
        }
      }
#pragma unroll
      for (int k = 0; k < kRepairDepth; ++k) {
        const int q = base + k * kThreads, c = 4 * q;
        if (q < n4) {
          top2_add_dense(t, v[k].x, o[k].x, c, hb, p.eps);
          top2_add_dense(t, v[k].y, o[k].y, c + 1, hb, p.eps);
          top2_add_dense(t, v[k].z, o[k].z, c + 2, hb, p.eps);
          top2_add_dense(t, v[k].w, o[k].w, c + 3, hb, p.eps);
        }
      }
    }
  } else {
    for (int c = threadIdx.x; c < p.N; c += kThreads)
      top2_add_dense(t, __ldg(srow + c), __ldcg(p.open_price + c), c, hb,
                     p.eps);
  }
  return block_top2(t);
}

// The key of column c of `row`: from the block's shared cache, or the
// score folded again.
__device__ __forceinline__ uint32_t row_key(const Params& p, int row,
                                            const float* srow,
                                            const uint32_t* keys_s, int c) {
  if (p.cache_keys) return keys_s[c];
  return float_key(fold(__ldg(srow + c), p.seed, row, c, p.eps));
}

// f(column, in range, key) over every column of `row`, four keys in
// flight per thread; every thread runs the same number of iterations (f
// may use the warp).
template <typename F>
__device__ __forceinline__ void for_keys(const Params& p, int row,
                                         const float* srow,
                                         const uint32_t* keys_s, F f) {
  constexpr int kU = 4;
  for (int base = 0; base < p.N; base += kU * kThreads) {
    uint32_t u[kU];
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int c = base + q * kThreads + static_cast<int>(threadIdx.x);
      u[q] = c < p.N ? row_key(p, row, srow, keys_s, c) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kU; ++q) {
      const int c = base + q * kThreads + static_cast<int>(threadIdx.x);
      f(c, c < p.N, u[q]);
    }
  }
}

// Pass 1: every score folded once, its key stored in the cache (when the
// row is cached); the thread's largest and smallest key (0 and ~0 for a
// thread with no column).
__device__ void fold_row(const Params& p, int row, const float* srow,
                         uint32_t* keys_s, uint32_t& mx, uint32_t& mn) {
  mx = 0u;
  mn = 0xffffffffu;
  auto take = [&](int c, float s) {
    const uint32_t u = float_key(fold(s, p.seed, row, c, p.eps));
    if (p.cache_keys) keys_s[c] = u;
    mx = max(mx, u);
    mn = min(mn, u);
  };
  constexpr int kU = 4;
  if ((p.N & 3) == 0 && (reinterpret_cast<uintptr_t>(srow) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    const int n4 = p.N >> 2;
    for (int base = threadIdx.x; base < n4; base += kU * kThreads) {
      float4 v[kU];
#pragma unroll
      for (int q = 0; q < kU; ++q)
        if (base + q * kThreads < n4) v[q] = __ldg(s4 + base + q * kThreads);
#pragma unroll
      for (int q = 0; q < kU; ++q) {
        const int j = base + q * kThreads;
        if (j < n4) {
          take(4 * j, v[q].x);
          take(4 * j + 1, v[q].y);
          take(4 * j + 2, v[q].z);
          take(4 * j + 3, v[q].w);
        }
      }
    }
  } else {
    for (int base = threadIdx.x; base < p.N; base += kU * kThreads) {
      float v[kU];
#pragma unroll
      for (int q = 0; q < kU; ++q)
        if (base + q * kThreads < p.N) v[q] = __ldg(srow + base + q * kThreads);
#pragma unroll
      for (int q = 0; q < kU; ++q)
        if (base + q * kThreads < p.N) take(base + q * kThreads, v[q]);
    }
  }
}

// The block's max of a, min of b, min of c and sum of d; every thread
// gets them (two barriers).
__device__ void block_reduce4(uint32_t& a, uint32_t& b, uint32_t& c,
                              uint32_t& d) {
  __shared__ uint32_t part[4][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = __reduce_max_sync(kFull, a);
  b = __reduce_min_sync(kFull, b);
  c = __reduce_min_sync(kFull, c);
  d = __reduce_add_sync(kFull, d);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
    part[2][warp] = c;
    part[3][warp] = d;
  }
  __syncthreads();
  const bool w = lane < kWarps;
  a = __reduce_max_sync(kFull, w ? part[0][lane] : 0u);
  b = __reduce_min_sync(kFull, w ? part[1][lane] : 0xffffffffu);
  c = __reduce_min_sync(kFull, w ? part[2][lane] : 0xffffffffu);
  d = __reduce_add_sync(kFull, w ? part[3][lane] : 0u);
  __syncthreads();
}

// The block's sums of x and y; every thread gets them (two barriers).
__device__ void block_sum2(uint32_t& x, uint32_t& y) {
  __shared__ uint32_t part[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(kFull, x);
  y = __reduce_add_sync(kFull, y);
  if (lane == 0) {
    part[0][warp] = x;
    part[1][warp] = y;
  }
  __syncthreads();
  const bool w = lane < kWarps;
  x = __reduce_add_sync(kFull, w ? part[0][lane] : 0u);
  y = __reduce_add_sync(kFull, w ? part[1][lane] : 0u);
  __syncthreads();
}

// Pass 2: every key >= L (> L when `strict`) into the list, as far as it
// holds; returns the counts of keys above L and equal to it (every thread
// gets them).
__device__ void compact(const Params& p, int row, const float* srow,
                        const uint32_t* keys_s, uint32_t L, bool strict,
                        unsigned long long* list, uint32_t& above,
                        uint32_t& equal) {
  __shared__ uint32_t count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  uint32_t a = 0, e = 0;
  const int lane = threadIdx.x & 31;
  for_keys(p, row, srow, keys_s, [&](int c, bool in, uint32_t u) {
    const bool gt = in && u > L, eq = in && u == L;
    a += gt;
    e += eq;
    const bool take = gt || (eq && !strict);
    const uint32_t m = __ballot_sync(kFull, take);
    if (m == 0u) return;
    uint32_t base = 0;
    if (lane == __ffs(m) - 1) base = atomicAdd(&count, __popc(m));
    base = __shfl_sync(kFull, base, __ffs(m) - 1);
    const uint32_t pos = base + __popc(m & lanes_below());
    if (take && pos < kCap)
      list[pos] = static_cast<unsigned long long>(u) << 32 |
                  ~static_cast<uint32_t>(c);
  });
  block_sum2(a, e);
  above = a;
  equal = e;
}

// The list's n entries ranked in (key descending, column ascending): the
// first K written to the row's shortlist in that order, and rank K-1's
// key as kth (n >= K).
__device__ void emit_ranked(const Params& p, int row,
                            const unsigned long long* list, int n) {
  float* sv = p.s_vals + static_cast<size_t>(row) * p.K;
  int32_t* cd = p.cand + static_cast<size_t>(row) * p.K;
  for (int x = threadIdx.x; x < n; x += kThreads) {
    const unsigned long long me = list[x];
    int r = 0;
#pragma unroll 8
    for (int y = 0; y < n; ++y) r += list[y] > me;
    if (r < p.K) {
      const uint32_t key = static_cast<uint32_t>(me >> 32);
      sv[r] = key_float(key);
      cd[r] = static_cast<int32_t>(~static_cast<uint32_t>(me));
      if (r == p.K - 1) p.kth[row] = key_float(key);
    }
  }
}

// The lowest `need` columns whose key is L, in column order, into the
// shortlist's entries from `from` on: an ordered walk of the row that
// stops once they are taken.
__device__ void emit_ties(const Params& p, int row, const float* srow,
                          const uint32_t* keys_s, uint32_t L, int from,
                          int need) {
  __shared__ uint32_t warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sv = p.s_vals + static_cast<size_t>(row) * p.K;
  int32_t* cd = p.cand + static_cast<size_t>(row) * p.K;
  int taken = 0;
  for (int base = 0; base < p.N && taken < need; base += kThreads) {
    const int c = base + static_cast<int>(threadIdx.x);
    const bool tie = c < p.N && row_key(p, row, srow, keys_s, c) == L;
    const uint32_t ball = __ballot_sync(kFull, tie);
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    int before = taken, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = static_cast<int>(warp_cnt[w]);
      if (w < warp) before += n;
      total += n;
    }
    before += __popc(ball & lanes_below());
    if (tie && before < need) {
      sv[from + before] = key_float(L);
      cd[from + before] = c;
    }
    taken += total;
    __syncthreads();
  }
}

// The exact path: an MSB-first radix select over the row's keys (four
// 8-bit histogram passes find the K-th largest key T and how many keys
// equal to T the set takes, the lowest columns), then a collection of the
// keys above T in any order and the ties at T in column order. Returns T.
__device__ uint32_t select_exact(const Params& p, int row, const float* srow,
                                 const uint32_t* keys_s) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_kk, s_gt;
  __shared__ unsigned warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned prefix = 0, mask = 0, kk = static_cast<unsigned>(p.K);
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = threadIdx.x; b < 256; b += kThreads) hist[b] = 0;
    __syncthreads();
    for_keys(p, row, srow, keys_s, [&](int, bool in, uint32_t u) {
      const bool take = in && (u & mask) == prefix;
      const unsigned bin = (u >> shift) & 255u;
      const unsigned peers = __match_any_sync(kFull, take ? bin : 0xffffffffu);
      if (take && __ffs(peers) - 1 == lane) atomicAdd(&hist[bin], __popc(peers));
    });
    __syncthreads();
    if (warp == 0) {
      // Lane l holds bins 255 - 8l down to 248 - 8l; the lane whose
      // range holds the kk-th largest key walks it.
      unsigned sum = 0;
      for (int j = 0; j < 8; ++j) sum += hist[255 - 8 * lane - j];
      unsigned before = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned n = __shfl_up_sync(kFull, before, o);
        if (lane >= o) before += n;
      }
      before -= sum;  // keys in the bins above this lane's
      if (before < kk && kk <= before + sum) {
        unsigned cum = before;
        for (int j = 0; j < 8; ++j) {
          const int b = 255 - 8 * lane - j;
          const unsigned h = hist[b];
          if (cum + h >= kk) {
            s_kk = kk - cum;
            s_prefix = prefix | static_cast<unsigned>(b) << shift;
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    kk = s_kk;
    mask |= 255u << shift;
    __syncthreads();
  }
  // The set takes every key above T (K - kk of them) and the kk lowest
  // columns whose key is T.
  if (threadIdx.x == 0) s_gt = 0;
  __syncthreads();
  const unsigned n_gt = static_cast<unsigned>(p.K) - kk;
  float* sv = p.s_vals + static_cast<size_t>(row) * p.K;
  int32_t* cd = p.cand + static_cast<size_t>(row) * p.K;
  unsigned eq_base = 0;
  for (int base = 0; base < p.N; base += kThreads) {
    const int c = base + threadIdx.x;
    const uint32_t u = c < p.N ? row_key(p, row, srow, keys_s, c) : 0u;
    const bool gt = c < p.N && u > prefix;
    const bool eq = c < p.N && u == prefix;
    if (gt) {
      const unsigned slot = atomicAdd(&s_gt, 1u);
      sv[slot] = key_float(u);
      cd[slot] = c;
    }
    const unsigned ball = __ballot_sync(kFull, eq);
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    unsigned before = eq_base, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned n = warp_cnt[w];
      if (w < warp) before += n;
      total += n;
    }
    before += __popc(ball & lanes_below());
    if (eq && before < kk) {
      sv[n_gt + before] = key_float(u);
      cd[n_gt + before] = c;
    }
    eq_base += total;
    const bool done = eq_base >= kk && s_gt == n_gt;
    __syncthreads();
    if (done) break;
  }
  return prefix;
}

// The shortlist of `row`: s_vals and cand (K entries), kth, feasible, and
// repaired cleared. Every thread of the block calls it.
__device__ void select_row(const Params& p, int row, uint32_t* keys_s,
                           unsigned long long* list) {
  const float* srow = p.scores + static_cast<size_t>(row) * p.N;
  uint32_t mx, mn;
  fold_row(p, row, srow, keys_s, mx, mn);
  uint32_t hi = mx, lo = mx != 0u ? mx : 0xffffffffu, least = mn;
  uint32_t owners = mx != 0u;
  block_reduce4(hi, lo, least, owners);  // keys cached: the barrier inside
  const uint32_t K = static_cast<uint32_t>(p.K);
  float* sv = p.s_vals + static_cast<size_t>(row) * p.K;
  int32_t* cd = p.cand + static_cast<size_t>(row) * p.K;
  uint32_t kth = 0;
  bool ranked = false;
  if (K == static_cast<uint32_t>(p.N)) {  // every column; kth the least
    for (int c = threadIdx.x; c < p.N; c += kThreads) {
      sv[c] = key_float(row_key(p, row, srow, keys_s, c));
      cd[c] = c;
    }
    kth = least;
  } else {
    // L: the K-th largest thread maximum (every key when fewer than K
    // threads hold a column).
    uint32_t L = 0u;
    if (owners >= K) {
      const int top = hi == lo ? -1 : 31 - __clz(hi ^ lo);
      L = top < 0 ? hi : hi & ~(0xffffffffu >> (31 - top));
      for (int bit = top; bit >= 0; --bit) {
        const uint32_t c = L | (1u << bit);
        if (static_cast<uint32_t>(__syncthreads_count(mx >= c)) >= K) L = c;
      }
    }
    uint32_t above, equal;
    compact(p, row, srow, keys_s, L, false, list, above, equal);
    if (above + equal <= static_cast<uint32_t>(kCap)) {
      emit_ranked(p, row, list, static_cast<int>(above + equal));
      ranked = true;
    } else if (above <= static_cast<uint32_t>(kCap)) {
      compact(p, row, srow, keys_s, L, true, list, above, equal);
      if (above >= K) {
        emit_ranked(p, row, list, static_cast<int>(above));
        ranked = true;
      } else {  // every key above L, and the lowest columns at L
        for (int x = threadIdx.x; x < static_cast<int>(above); x += kThreads) {
          const unsigned long long e = list[x];
          sv[x] = key_float(static_cast<uint32_t>(e >> 32));
          cd[x] = static_cast<int32_t>(~static_cast<uint32_t>(e));
        }
        emit_ties(p, row, srow, keys_s, L, static_cast<int>(above),
                  static_cast<int>(K - above));
        kth = L;
      }
    } else {
      kth = select_exact(p, row, srow, keys_s);
    }
  }
  if (threadIdx.x == 0) {
    if (!ranked) p.kth[row] = key_float(kth);
    p.feasible[row] = hi > float_key(kNeg);
    p.repaired[row] = 0;
  }
  // The cache and the list are rewritten for the block's next row.
  __syncthreads();
}

// f(j) for each entry j of the block whose pred(j) holds, by the whole
// block (every thread calls it; f may use the block); `idx` holds
// kThreads entries of shared memory.
template <typename Pred, typename F>
__device__ void for_marked(int n, int32_t* idx, Pred pred, F f) {
  __shared__ int taken;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + threadIdx.x;
    const bool m = j < n && pred(j);
    if (threadIdx.x == 0) taken = 0;
    const int c = __syncthreads_count(m);
    if (c == 0) continue;
    if (m) idx[atomicAdd(&taken, 1)] = j;
    __syncthreads();
    for (int r = 0; r < c; ++r) f(idx[r]);
    __syncthreads();
  }
}

}  // namespace

// kDevice: the block's Pods in device memory (its share of the batch does
// not fit in shared memory beside the list and the row cache).
template <bool kDevice>
__global__ void __launch_bounds__(kThreads, 1) bid_auction_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Pods<kDevice> L = carve_pods<kDevice>(p, smem);
  const size_t pods_bytes = kDevice ? 0 : local_bytes(p.local);
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(smem + pods_bytes);
  uint32_t* keys_s =
      reinterpret_cast<uint32_t*>(smem + pods_bytes + kListBytes);
  unsigned target = 0;
  init_state(p);
  for (int i = blockIdx.x; i < p.P; i += gridDim.x)
    select_row(p, i, keys_s, list);
  init_local(p, L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t* idx = reinterpret_cast<int32_t*>(list);  // free during rounds
  run_rounds(p, L, target, false, [&](const Loop& s) {
    auto active = [&](int j) {
      const int x = L.at(j);
      return L.ld(L.chosen + x) < 0 && L.ld(L.prio + x) == s.band;
    };
    if (p.K <= kWarpK) {
      // A warp per pod (entries warp, warp + kWarps, ...: the warp's lanes
      // find its active ones); the uncertified ones are marked for the
      // block.
      for (int b = warp; b < L.n; b += 32 * kWarps) {
        const int jj = b + lane * kWarps;
        uint32_t m = __ballot_sync(kFull, jj < L.n && active(jj));
        while (m) {
          const int j = b + (__ffs(m) - 1) * kWarps;
          m &= m - 1;
          const int i = pod_of(j);
          const float* sv = p.s_vals + static_cast<size_t>(i) * p.K;
          const int32_t* cd = p.cand + static_cast<size_t>(i) * p.K;
          const float kth = __ldcg(p.kth + i);
          Top2 t = top2_empty();
          for (int c = lane; c < p.K; c += 32) {
            const float v = __ldcg(sv + c);
            const int col = __ldcg(cd + c);
            const float op = __ldcg(p.open_price + col);
            top2_add(t, (v > kNeg && op == op) ? __fsub_rn(v, op) : kNeg, col);
          }
          t = warp_top2(t);
          if (lane == 0) {
            if ((t.v > kth && t.v2 >= kth) || kth <= kNeg) {
              post_bid(p, L, L.at(j), i, t, s.rnd);
            } else {
              L.st(L.key + L.at(j), kRepair);
              p.repaired[i] = 1;
            }
          }
        }
      }
      __syncthreads();
      for_marked(
          L.n, idx, [&](int j) { return L.ld(L.key + L.at(j)) == kRepair; },
          [&](int j) {
            const int i = pod_of(j);
            const Top2 t = dense_top2(p, i);
            if (threadIdx.x == 0) post_bid(p, L, L.at(j), i, t, s.rnd);
          });
    } else {
      // Wide shortlists: the whole block per pod.
      for_marked(L.n, idx, active, [&](int j) {
        const int i = pod_of(j);
        const float* sv = p.s_vals + static_cast<size_t>(i) * p.K;
        const int32_t* cd = p.cand + static_cast<size_t>(i) * p.K;
        Top2 t = top2_empty();
        for (int c = threadIdx.x; c < p.K; c += kThreads) {
          const float v = __ldcg(sv + c);
          const int col = __ldcg(cd + c);
          const float op = __ldcg(p.open_price + col);
          top2_add(t, (v > kNeg && op == op) ? __fsub_rn(v, op) : kNeg, col);
        }
        t = block_top2(t);
        const float kth = __ldcg(p.kth + i);
        if (!((t.v > kth && t.v2 >= kth) || kth <= kNeg)) {
          if (threadIdx.x == 0) p.repaired[i] = 1;
          t = dense_top2(p, i);
        }
        if (threadIdx.x == 0) post_bid(p, L, L.at(j), i, t, s.rnd);
      });
    }
  });
}

namespace {

// A launch's shape: the grid, whether each row's keys are cached in
// shared memory and whether the block's Pods lie there too. The row cache
// comes first (it serves every pass of the selection); the Pods join it
// where they fit beside the list, else they go to device memory.
struct Layout {
  const void* kernel;
  int nblocks, local, cache_keys, shared_pods;
  size_t smem;
};

int plan(int P, int N, Layout* out) {
  const void* kernels[2] = {
      reinterpret_cast<const void*>(bid_auction_kernel<false>),
      reinterpret_cast<const void*>(bid_auction_kernel<true>)};
  int sms = 0;
  size_t budget[2];
  for (int d = 0; d < 2; ++d) {
    const int err = device_limits(kernels[d], &sms, &budget[d]);
    if (err != 0) return err;
  }
  Params shape{};
  shape.P = P;
  shape.N = N;
  const int nblocks = grid_for(shape, sms);
  const int local = (P + nblocks - 1) / nblocks;
  const size_t row_bytes = sizeof(uint32_t) * static_cast<size_t>(N);
  for (int cache = 1; cache >= 0; --cache) {
    for (int shared = 1; shared >= 0; --shared) {
      const size_t need = (shared ? local_bytes(local) : 0) + kListBytes +
                          (cache ? row_bytes : 0);
      if (need <= budget[shared ? 0 : 1]) {
        *out = Layout{kernels[shared ? 0 : 1], nblocks, local, cache, shared,
                      need};
        return 0;
      }
    }
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" long long bid_auction_scratch_bytes(int P, int N, int K) {
  return static_cast<long long>(scratch_bytes(P, N, K));
}

// The layout a launch of P x N would take: out = {row keys cached, Pods
// in shared memory, dynamic shared memory bytes, blocks}. Returns 0 or a
// cudaError_t.
extern "C" int bid_auction_layout(int P, int N, int* out) {
  Layout l;
  const int err = plan(P, N, &l);
  if (err != 0) return err;
  out[0] = l.cache_keys;
  out[1] = l.shared_pods;
  out[2] = static_cast<int>(l.smem);
  out[3] = l.nblocks;
  return 0;
}

extern "C" int bid_auction_launch(const float* scores, const float* requests,
                                  const float* free0, const int32_t* priority,
                                  uint32_t seed, float eps, float half_eps,
                                  int max_rounds, int P, int N, int R, int K,
                                  int32_t* chosen, uint8_t* assigned,
                                  float* free_after, uint8_t* repaired,
                                  int32_t* rounds, void* scratch,
                                  void* stream) {
  Params p{};
  p.scores = scores;
  p.req = requests;
  p.free0 = free0;
  p.prio = priority;
  p.P = P;
  p.N = N;
  p.R = R;
  p.K = K;
  p.seed = seed;
  p.eps = eps;
  p.half_eps = half_eps;
  p.max_rounds = max_rounds;
  p.chosen = chosen;
  p.assigned = assigned;
  p.free = free_after;
  p.repaired = repaired;
  p.rounds = rounds;
  if (K < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = prelude(p, st);
  if (pre != 0) return pre;
  carve(p, scratch);
  Layout l;
  const int err = plan(P, N, &l);
  if (err != 0) return err;
  p.local = l.local;
  p.cache_keys = l.cache_keys;
  return launch(l.kernel, p, st, l.nblocks, l.smem);
}

extern "C" const char* bid_auction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
