// The banded bidding rounds shared by the two auction kernels
// (csrc/auction.cu, the dense rounds; csrc/bid_auction.cu, the rounds over
// per-pod shortlists). Both run the JAX package's whole while_loop in one
// cooperative launch: minisched_tpu/ops/auction.py:104-253 and
// minisched_tpu/ops/bid_select.py:76-210.
//
// Launch: one block of kThreads per SM (fewer for a small batch), every
// block resident. Pod p belongs to block p % G for the whole launch: the
// block settles its pods' bids and reduces their part of the loop control.
// A pod's round state (Pods: its node once assigned, its priority, and the
// round's bid: key, node, margin) lies in the block's dynamic shared
// memory while a block's share of the batch fits there beside what the
// kernel keeps, else in device memory, indexed by pod (any batch size that
// device memory holds). The dense kernel keeps it in device memory always:
// any block may post any pod's bid. A round:
//
//   node walk (only when the band advanced or its least request moved):
//       the grid walks the nodes: prices reset when the band advanced,
//       and the round's open price written (the price of a node whose
//       free capacity covers the band's least request on every axis, NaN
//       for a closed node); a grid barrier;
//   bids: the kernel's bid phase posts a bid for every active pod (the
//       dense kernel spreads (pod, column tile) units over every warp of
//       the grid; the shortlist kernel gives each pod a warp of its
//       owner); a bid is gamma = (v_best - v2 or 0) + eps, strength =
//       fma(noise(seed, round, pod), eps / 2, v_best), the 64-bit key
//       (strength's total-order key << 32 | pod), raised into the node's
//       winner key with one atomicMax; a grid barrier;
//   winners: one thread per pod of the block: the pod whose key is its
//       node's winner key is the node's one winner (argsort(argsort(.)) of
//       the JAX package, which is stable, ranks ties by row). It clears
//       the node's winner key for the next round; if its request fits the
//       node's free row (read before any debit of the round: only the
//       winner touches it) it takes the node and debits it with one IEEE
//       subtraction per axis; the price rises by its gamma either way (one
//       IEEE addition), and the node's open price follows under the
//       round's least request (a later walk overwrites it if the band or
//       its least request moves). Both equal the JAX package's one-hot
//       matmuls, which add one winner per node.
//   control: each block reduces its own pods to a partial (any winner that
//       fit, any unassigned pod left in the band, the highest priority
//       below the band, the least request per axis in the band and at that
//       priority) and folds it into a few control words by atomics
//       (double-buffered by round parity); after the round's last grid
//       barrier every block reads them into the same loop state: the stale
//       count, the band (advanced when it is assigned or 8 rounds pass
//       without a winner that fits), the round count, the least request
//       and whether the next round walks the nodes. The exit needs no host
//       read.
//
// So a round is two grid barriers, three when the nodes are walked; the
// walk's open prices stay right between walks because a node's price and
// free row change only through its winner, which updates its open price.
//
// Active lists (the dense kernel): the bid phase needs the round's active
// pods in one list that every block reads. Each block appends its own
// before a grid barrier: the pods left in the band after its settle (the
// next round's list if the band stands), and, when the band advances, the
// new band's pods during the walk. Each list has its own count, in four
// words by round parity; block 0 zeroes a parity's two after the round
// that read them.
//
// Exactness: the fold of the tie noise into the scores and the strength
// are one fused multiply-add each, as XLA compiles them (__fmaf_rn); every
// other operation is a single IEEE operation (__fsub_rn, __fadd_rn).
// Values that other blocks write are read with __ldcg (L2), after a grid
// barrier (release and acquire at gpu scope).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace auction {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 32;
constexpr int kCtlWords = 1 + 2 * kMaxR;  // a control buffer, 64-bit words
constexpr int kStale = 8;
constexpr int kNegBand = -2147483647;  // -(2^31) + 1: no band left
constexpr int kNoLaunch = -1;           // no cudaError_t is negative
constexpr float kNeg = -3.0e38f;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kInfKey = 0xff800000u;  // float_key(+inf)

struct Params {
  const float* scores;    // (P,N) NEG on infeasible pairs
  const float* req;       // (P,R)
  const float* free0;     // (N,R)
  const int32_t* prio;    // (P,)
  int P, N, R, K;
  uint32_t seed;
  float eps, half_eps;
  int max_rounds;
  int32_t* chosen;        // (P,) out
  uint8_t* assigned;      // (P,) out
  float* free;            // (N,R) out: the running free capacity
  uint8_t* repaired;      // (P,) out, shortlist only
  int32_t* rounds;        // (1,) out: the rounds run
  // scratch
  float* prices;                  // (N,)
  float* open_price;              // (N,) price if open, NaN if closed
  unsigned long long* node_key;   // (N,) the round's winning bid key
  uint8_t* feasible;              // (P,) any score above NEG
  float* s_vals;                  // (P,K) shortlist only
  int32_t* cand;                  // (P,K) shortlist only
  float* kth;                     // (P,) shortlist only
  // The pods' round state in device memory, by pod (Pods<true>).
  unsigned long long* pod_key;    // (P,)
  int32_t* pod_best;              // (P,)
  float* pod_gamma;               // (P,)
  int32_t* pod_chosen;            // (P,)
  int32_t* pod_prio;              // (P,)
  int32_t* act;                   // (P,) the round's active pods (dense)
  unsigned long long* ctl;        // (2, kCtlWords) the blocks' partials,
                                  // reduced by atomics, by round parity
  unsigned int* bar;              // grid barrier arrivals
  unsigned int* act_n;            // (4,) active-list counts (dense)
  // launch shape
  int local;                      // pods per block, ceil(P / G)
  int cache_keys;                 // shortlist: the row's keys fit in the
                                  // block's dynamic shared memory
  // the dense kernel's bid units
  int4* part;                     // (P, tiles) each tile's Top2 as bits
  unsigned int* count;            // (P,) the pod's tiles counted this round
  int tiles;                      // column tiles a row
  int vec;                        // rows start 16-byte aligned, N % 4 == 0
  int staged;                     // the open prices fit in shared memory
};

// Bytes of scratch a launch needs, and their layout (16-byte aligned).
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~15; }

// The control buffers, the barrier and the list counts: zeroed together
// by the launcher.
constexpr size_t kZeroed = 16ull * kCtlWords + 16 + 16;

inline size_t scratch_bytes(int P, int N, int K) {
  size_t b = 0;
  b += align16(4ull * N) * 2 + align16(8ull * N);                // nodes
  b += align16(P);                                               // pods
  b += align16(4ull * P * K) * 2 + align16(4ull * P);            // shortlist
  b += align16(8ull * P) + 5 * align16(4ull * P);                // Pods, act
  b += kZeroed;                                                  // control
  return b;
}

// Carves the shared scratch; returns its end (a kernel's own scratch
// follows).
inline char* carve(Params& p, void* scratch) {
  char* c = static_cast<char*>(scratch);
  auto take = [&c](size_t n) {
    char* r = c;
    c += align16(n);
    return r;
  };
  const size_t P = p.P, N = p.N, K = p.K;
  p.prices = reinterpret_cast<float*>(take(4 * N));
  p.open_price = reinterpret_cast<float*>(take(4 * N));
  p.node_key = reinterpret_cast<unsigned long long*>(take(8 * N));
  p.feasible = reinterpret_cast<uint8_t*>(take(P));
  p.s_vals = reinterpret_cast<float*>(take(4 * P * K));
  p.cand = reinterpret_cast<int32_t*>(take(4 * P * K));
  p.kth = reinterpret_cast<float*>(take(4 * P));
  p.pod_key = reinterpret_cast<unsigned long long*>(take(8 * P));
  p.pod_best = reinterpret_cast<int32_t*>(take(4 * P));
  p.pod_gamma = reinterpret_cast<float*>(take(4 * P));
  p.pod_chosen = reinterpret_cast<int32_t*>(take(4 * P));
  p.pod_prio = reinterpret_cast<int32_t*>(take(4 * P));
  p.act = reinterpret_cast<int32_t*>(take(4 * P));
  p.ctl = reinterpret_cast<unsigned long long*>(take(16ull * kCtlWords));
  p.bar = reinterpret_cast<unsigned int*>(take(16));
  p.act_n = reinterpret_cast<unsigned int*>(take(16));
  return c;
}

__device__ __forceinline__ int pod_of(int j) {
  return blockIdx.x + j * gridDim.x;
}

// Bytes of a block's Pods in shared memory, for `local` pods.
__host__ __device__ inline size_t local_bytes(int local) {
  return align16(8ull * local) + 4 * align16(4ull * local);
}

// The block's pods: entry j is pod pod_of(j). In shared memory (kDevice
// false: entry j at index j, plain loads) or in device memory (index
// pod_of(j), loads and stores at L2: another block may have written it).
template <bool kDevice>
struct Pods {
  unsigned long long* key;  // the round's bid key, 0 for none
  int32_t* best;            // the bid's node
  float* gamma;             // the bid's price rise
  int32_t* chosen;          // the node once assigned, else -1
  int32_t* prio;            // priority; kNegBand if infeasible
  int n;                    // this block's pods

  __device__ __forceinline__ int at(int j) const {
    return kDevice ? pod_of(j) : j;
  }
  template <typename T>
  __device__ __forceinline__ static T ld(const T* a) {
    if constexpr (kDevice) {
      return __ldcg(a);
    } else {
      return *a;
    }
  }
  template <typename T>
  __device__ __forceinline__ static void st(T* a, T v) {
    if constexpr (kDevice) {
      __stcg(a, v);
    } else {
      *a = v;
    }
  }
};

template <bool kDevice>
__device__ inline Pods<kDevice> carve_pods(const Params& p,
                                           unsigned char* smem) {
  Pods<kDevice> L;
  if constexpr (kDevice) {
    L.key = p.pod_key;
    L.best = p.pod_best;
    L.gamma = p.pod_gamma;
    L.chosen = p.pod_chosen;
    L.prio = p.pod_prio;
  } else {
    L.key = reinterpret_cast<unsigned long long*>(smem);
    smem += align16(8ull * p.local);
    L.best = reinterpret_cast<int32_t*>(smem);
    smem += align16(4ull * p.local);
    L.gamma = reinterpret_cast<float*>(smem);
    smem += align16(4ull * p.local);
    L.chosen = reinterpret_cast<int32_t*>(smem);
    smem += align16(4ull * p.local);
    L.prio = reinterpret_cast<int32_t*>(smem);
  }
  const int b = blockIdx.x, g = gridDim.x;
  L.n = p.P > b ? (p.P - b + g - 1) / g : 0;
  return L;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// tie_noise_from_cols(seed, i, col): uniform in [0, 1), exact in float32.
__device__ __forceinline__ float noise(uint32_t seed, uint32_t i,
                                       uint32_t col) {
  const uint32_t x = fmix32(col * kColMult + seed + i * kGolden) >> 8;
  return __fmul_rn(__uint2float_rn(x), 1.0f / 16777216.0f);
}

// where(s > NEG, s + noise(seed, row, col) * eps, NEG), one rounding.
__device__ __forceinline__ float fold(float s, uint32_t seed, int row,
                                      int col, float eps) {
  return s > kNeg ? __fmaf_rn(noise(seed, row, col), eps, s) : kNeg;
}

// lax.sort's total order on float32 as an unsigned key (-0.0 below +0.0).
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Grid barrier on an arrival count that only grows: the k-th barrier
// waits for k * gridDim.x arrivals (the launcher zeroes the count).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The best value, the lowest column holding it, and the best value over
// the other columns.
struct Top2 {
  float v;
  int col;
  float v2;
};

__device__ __forceinline__ Top2 top2_empty() {
  return Top2{kNeg, 0x7fffffff, kNeg};
}

__device__ __forceinline__ void top2_add(Top2& t, float v, int col) {
  if (v > t.v || (v == t.v && col < t.col)) {
    t.v2 = fmaxf(t.v2, t.v);
    t.v = v;
    t.col = col;
  } else {
    t.v2 = fmaxf(t.v2, v);
  }
}

// One score of a row's running top two in a dense round, its columns
// arriving in increasing order (a tie keeps the earlier column): the
// value is the folded score less the node's open price op, hb = seed +
// row * kGolden. No test is needed: an infeasible pair's value (at most
// NEG) or a closed node's (NaN) never beats the running best and leaves
// v2 at least NEG, exactly as the value NEG would.
__device__ __forceinline__ void top2_add_dense(Top2& t, float s, float op,
                                               int c, uint32_t hb,
                                               float eps) {
  const uint32_t x = fmix32(static_cast<uint32_t>(c) * kColMult + hb) >> 8;
  const float n = __fmul_rn(__uint2float_rn(x), 1.0f / 16777216.0f);
  const float v = __fsub_rn(__fmaf_rn(n, eps, s), op);
  const bool up = v > t.v;
  t.v2 = fmaxf(t.v2, up ? t.v : v);
  t.col = up ? c : t.col;
  t.v = up ? v : t.v;
}

__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  if (b.v > a.v || (b.v == a.v && b.col < a.col))
    return Top2{b.v, b.col, fmaxf(b.v2, a.v)};
  return Top2{a.v, a.col, fmaxf(a.v2, b.v)};
}

__device__ __forceinline__ Top2 top2_shfl(const Top2& t, int o) {
  return Top2{__shfl_xor_sync(kFull, t.v, o), __shfl_xor_sync(kFull, t.col, o),
              __shfl_xor_sync(kFull, t.v2, o)};
}

__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = top2_merge(t, top2_shfl(t, o));
  return t;
}

// The loop state, the same on every block, in shared memory.
struct Loop {
  int band;
  int stale;
  int rnd;
  int reset;  // the band advanced: prices restart at 0
  int walk;   // the next round walks the nodes
  float min_req[kMaxR];  // the band's least request per axis
};

// The count of round `rnd`'s active list: built after the previous
// round's settle (`walked` false) or, when the band advanced, during the
// round's walk.
__device__ __forceinline__ unsigned* list_count(const Params& p, int rnd,
                                                bool walked) {
  return p.act_n + ((rnd & 1) << 1) + (walked ? 1 : 0);
}

// Append the pods of the block's entries whose `act` is set (a warp-
// uniform call) to the active list counted by `n`.
__device__ __forceinline__ void list_append(const Params& p, unsigned* n,
                                            bool act, int i) {
  const unsigned m = __ballot_sync(kFull, act);
  if (!m) return;
  const int lane = threadIdx.x & 31, lead = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == lead) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(kFull, base, lead);
  if (act) __stcg(p.act + base + __popc(m & ((1u << lane) - 1u)), i);
}

// The block's unassigned pods of `band` appended to the list counted by
// `n` (every thread calls it).
template <bool kDevice>
__device__ void list_band(const Params& p, const Pods<kDevice>& L, int band,
                          unsigned* n) {
  for (int base = 0; base < L.n; base += kThreads) {
    const int j = base + threadIdx.x;
    bool act = false;
    if (j < L.n) {
      const int x = L.at(j);
      act = L.ld(L.prio + x) == band && L.ld(L.chosen + x) < 0;
    }
    list_append(p, n, act, pod_of(j));
  }
}

// Post pod i's bid from its Top2 (one thread); x is its index in the
// Pods' arrays.
template <bool kDevice>
__device__ __forceinline__ void post_bid(const Params& p,
                                         const Pods<kDevice>& L, int x,
                                         int i, const Top2& t, int rnd) {
  unsigned long long key = 0ull;
  if (t.v > kNeg) {
    const float margin = t.v2 > kNeg ? __fsub_rn(t.v, t.v2) : 0.0f;
    const float strength = __fmaf_rn(noise(p.seed, rnd, i), p.half_eps, t.v);
    key = static_cast<unsigned long long>(float_key(strength)) << 32 |
          static_cast<uint32_t>(i);
    L.st(L.best + x, static_cast<int32_t>(t.col));
    L.st(L.gamma + x, __fadd_rn(margin, p.eps));
    atomicMax(p.node_key + t.col, key);
  }
  L.st(L.key + x, key);
}

// The node walk: prices (reset when the band advanced), cleared winner
// keys and the round's open prices, grid-strided.
__device__ void walk_nodes(const Params& p, const Loop& s) {
  const float nan = __uint_as_float(0x7fffffffu);
  for (int n = blockIdx.x * kThreads + threadIdx.x; n < p.N;
       n += gridDim.x * kThreads) {
    float price = __ldcg(p.prices + n);
    if (s.reset) {
      price = 0.0f;
      p.prices[n] = 0.0f;
      p.node_key[n] = 0ull;
    }
    bool open = true;
    for (int r = 0; r < p.R; ++r)
      open &= __ldcg(p.free + static_cast<size_t>(n) * p.R + r) >=
              s.min_req[r];
    p.open_price[n] = open ? price : nan;
  }
}

// The winners among the block's pods, one thread each; every bid key is
// cleared for the next round. Returns whether a winner of the block fit
// (every thread gets it).
template <bool kDevice>
__device__ bool settle(const Params& p, const Pods<kDevice>& L,
                       const Loop& s) {
  const float nan = __uint_as_float(0x7fffffffu);
  bool fit_any = false;
  for (int j = threadIdx.x; j < L.n; j += kThreads) {
    const int x = L.at(j);
    const unsigned long long key = L.ld(L.key + x);
    if (!key) continue;
    L.st(L.key + x, 0ull);
    const int b = L.ld(L.best + x);
    if (__ldcg(p.node_key + b) != key) continue;  // another pod won b
    p.node_key[b] = 0ull;  // read by every bidder of b before it is cleared
                           // or after: either way not their key
    const int i = pod_of(j);
    float* fr = p.free + static_cast<size_t>(b) * p.R;
    const float* rq = p.req + static_cast<size_t>(i) * p.R;
    float f[kMaxR];
    bool fits = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < p.R) {
        f[r] = __ldcg(fr + r);
        fits &= f[r] >= __ldg(rq + r);
      }
    }
    bool open = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r < p.R) {
        if (fits) {
          f[r] = __fsub_rn(f[r], __ldg(rq + r));
          fr[r] = f[r];
        }
        open &= f[r] >= s.min_req[r];
      }
    }
    if (fits) {
      L.st(L.chosen + x, static_cast<int32_t>(b));
      fit_any = true;
    }
    const float price = __fadd_rn(__ldcg(p.prices + b), L.ld(L.gamma + x));
    p.prices[b] = price;
    p.open_price[b] = open ? price : nan;
  }
  return __syncthreads_or(fit_any);
}

// This block's control partial after a round (or, `first`, before the
// first), folded into control buffer `gen & 1` by atomics whose identity
// is 0 (the launcher zeroes both buffers; block 0 zeroes each again when
// it is next needed): word 0 ORs 1 if a winner fit | 2 if an unassigned
// feasible pod is left in the band; word 1 + r takes the maximum of the
// complemented float key of the least request on axis r over the band's
// unassigned pods (so the minimum request); word 1 + R + r the maximum of
// (priority + 2^31) << 32 | complemented key of the least request at the
// block's highest priority below the band (any priority when `first`),
// whose maximum is the highest such priority's least request. With
// `list`, the pods left in the band are appended to that active list.
template <bool kDevice>
__device__ void publish_partial(const Params& p, const Pods<kDevice>& L,
                                int band, bool first, bool fit, unsigned gen,
                                unsigned* list) {
  __shared__ int next_s;
  __shared__ uint32_t min_s[2 * kMaxR];
  if (threadIdx.x == 0) next_s = kNegBand;
  if (threadIdx.x < 2 * kMaxR) min_s[threadIdx.x] = kInfKey;
  __syncthreads();
  bool left = false;
  int next = kNegBand;
  for (int base = 0; base < L.n; base += kThreads) {
    const int j = base + threadIdx.x;
    bool cur = false;
    if (j < L.n) {
      const int x = L.at(j);
      const int pr = L.ld(L.prio + x);
      if (pr != kNegBand && L.ld(L.chosen + x) < 0) {
        cur = !first && pr == band;
        if (first || pr < band) next = max(next, pr);
      }
    }
    left |= cur;
    if (list) list_append(p, list, cur, pod_of(j));
  }
  next = __reduce_max_sync(kFull, next);
  if ((threadIdx.x & 31) == 0 && next > kNegBand) atomicMax(&next_s, next);
  left = __syncthreads_or(left);
  next = next_s;
  for (int j = threadIdx.x; j < L.n; j += kThreads) {
    const int x = L.at(j);
    const int pr = L.ld(L.prio + x);
    if (pr == kNegBand || L.ld(L.chosen + x) >= 0) continue;
    const bool cur = !first && pr == band, nxt = pr == next;
    if (!cur && !nxt) continue;
    const float* rq = p.req + static_cast<size_t>(pod_of(j)) * p.R;
    for (int r = 0; r < p.R; ++r) {
      const uint32_t k = float_key(__ldg(rq + r));
      if (cur) atomicMin(&min_s[r], k);
      if (nxt) atomicMin(&min_s[kMaxR + r], k);
    }
  }
  __syncthreads();
  unsigned long long* c = p.ctl + (gen & 1) * kCtlWords;
  if (threadIdx.x == 0 && (fit || left))
    atomicOr(c, (fit ? 1ull : 0ull) | (left ? 2ull : 0ull));
  if (threadIdx.x < p.R) {
    const uint32_t cur = min_s[threadIdx.x];
    if (cur != kInfKey) atomicMax(c + 1 + threadIdx.x, ~cur);
    atomicMax(c + 1 + p.R + threadIdx.x,
              static_cast<unsigned long long>(
                  static_cast<uint32_t>(next) + 0x80000000u) << 32 |
                  ~min_s[kMaxR + threadIdx.x]);
  }
}

// The round's last barrier, with the loop state of the next round: after
// it every block reads control buffer `gen & 1` (every partial folded in)
// and updates its copy of the loop state, the same on every block; block
// 0 then zeroes the other buffer, which every block read at the previous
// control barrier and which no block writes before the next round's
// bids are done (so before block 0 has passed another barrier).
__device__ void control_sync(const Params& p, Loop& s, unsigned& target,
                             unsigned& gen, bool first) {
  __shared__ unsigned long long ctl_s[kCtlWords];
  grid_sync(p.bar, target);
  const unsigned long long* c = p.ctl + (gen & 1) * kCtlWords;
  if (threadIdx.x < 1 + 2 * p.R) ctl_s[threadIdx.x] = __ldcg(c + threadIdx.x);
  __syncthreads();
  const int flags = static_cast<int>(ctl_s[0]);
  const bool fit = flags & 1, left = flags & 2;
  // Thread 0 updates the shared state; the others read it after a barrier.
  if (threadIdx.x == 0) {
    bool reset = true;
    if (first) {
      s.stale = 0;
      s.rnd = 0;
    } else {
      s.stale = fit ? 0 : s.stale + 1;
      reset = !left || s.stale >= kStale;
      if (reset) s.stale = 0;
      s.rnd += 1;
    }
    if (reset)
      s.band = static_cast<int>(static_cast<uint32_t>(ctl_s[1 + p.R] >> 32) -
                                0x80000000u);
    bool moved = reset;
    for (int r = 0; r < p.R; ++r) {
      const float m = key_float(~static_cast<uint32_t>(
          ctl_s[(reset ? 1 + p.R : 1) + r]));
      moved |= __float_as_uint(m) != __float_as_uint(s.min_req[r]);
      s.min_req[r] = m;
    }
    s.reset = reset;
    s.walk = moved;
  }
  gen += 1;
  if (blockIdx.x == 0 && threadIdx.x < kCtlWords)
    p.ctl[(gen & 1) * kCtlWords + threadIdx.x] = 0ull;
  __syncthreads();
}

// The whole banded loop, after the kernel's set-up: free = free0 (grid-
// wide), each row's feasibility known to its owner, the block's Pods
// loaded and its first partial published (init_local). `bid_phase(s)` is
// called by every thread of every block once per round and posts the
// bids of the round's active pods (post_bid); every other key stays 0.
// With `listed`, the blocks build each round's active list (the lists'
// counts: list_count).
template <bool kDevice, typename BidPhase>
__device__ void run_rounds(const Params& p, const Pods<kDevice>& L,
                           unsigned& target, bool listed,
                           BidPhase bid_phase) {
  __shared__ Loop s;
  unsigned gen = 0;
  if (threadIdx.x == 0) {
    for (int r = 0; r < kMaxR; ++r) s.min_req[r] = 0.0f;
  }
  control_sync(p, s, target, gen, true);
  while (s.rnd < p.max_rounds && s.band > kNegBand) {
    if (s.walk) {
      walk_nodes(p, s);
      if (listed && s.reset)
        list_band(p, L, s.band, list_count(p, s.rnd, true));
      grid_sync(p.bar, target);
    }
    bid_phase(s);
    grid_sync(p.bar, target);
    const bool fit = settle(p, L, s);
    publish_partial(p, L, s.band, false, fit, gen,
                    listed ? list_count(p, s.rnd + 1, false) : nullptr);
    control_sync(p, s, target, gen, false);
    // The finished round's list counts, zeroed for the round after next.
    if (listed && blockIdx.x == 0 && threadIdx.x < 2)
      p.act_n[((s.rnd + 1) & 1) * 2 + threadIdx.x] = 0u;
  }
  for (int j = threadIdx.x; j < L.n; j += kThreads) {
    const int i = pod_of(j);
    const int32_t c = L.ld(L.chosen + L.at(j));
    p.chosen[i] = c;
    p.assigned[i] = c >= 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) p.rounds[0] = s.rnd;
}

// The set-up every launch shares: free = free0 (grid-wide).
__device__ void init_state(const Params& p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int step = gridDim.x * kThreads;
  const size_t nr = static_cast<size_t>(p.N) * p.R;
  for (size_t i = t; i < nr; i += step) p.free[i] = p.free0[i];
}

// After the rows' feasibility is in p.feasible (each row by its owner,
// before a __syncthreads): the block's Pods, and its first partial.
template <bool kDevice>
__device__ void init_local(const Params& p, const Pods<kDevice>& L) {
  for (int j = threadIdx.x; j < L.n; j += kThreads) {
    const int i = pod_of(j), x = L.at(j);
    L.st(L.chosen + x, static_cast<int32_t>(-1));
    L.st(L.key + x, 0ull);
    L.st(L.prio + x, p.feasible[i] ? __ldg(p.prio + i) : kNegBand);
  }
  __syncthreads();
  publish_partial(p, L, 0, true, false, 0, nullptr);
}

// The grid of a launch: a block per pod row up to one per SM, and enough
// for the node walk.
inline int grid_for(const Params& p, int sms) {
  const int want = p.P > (p.N + kThreads - 1) / kThreads
                       ? p.P
                       : (p.N + kThreads - 1) / kThreads;
  return want < sms ? (want > 0 ? want : 1) : sms;
}

// Launch `kernel` cooperatively on `p` (scratch carved, p.local set for
// `nblocks`) with `smem` bytes of dynamic shared memory; returns the
// launch's cudaError_t.
inline int launch(const void* kernel, Params& p, cudaStream_t st,
                  int nblocks, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(p.ctl, 0, kZeroed, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The device's SM count and the dynamic shared memory a block of
// `kernel` may use.
inline int device_limits(const void* kernel, int* sms, size_t* budget) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *budget = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return 0;
}

// Checks and the empty batch shared by both entry points: returns
// kNoLaunch after copying free0 when there is no pod, an error for bad
// sizes, or 0 to go on.
inline int prelude(const Params& p, cudaStream_t st) {
  if (p.N < 1 || p.P < 0 || p.R < 1 || p.R > kMaxR || p.K < 0 || p.K > p.N)
    return cudaErrorInvalidValue;
  if (p.P == 0) {
    cudaError_t err = cudaMemcpyAsync(p.free, p.free0,
                                      sizeof(float) * p.N * p.R,
                                      cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(p.rounds, 0, sizeof(int32_t), st);
    return err != cudaSuccess ? err : kNoLaunch;
  }
  return 0;
}

}  // namespace auction
