// The banded bidding rounds shared by the two auction kernels
// (csrc/auction.cu, the dense rounds; csrc/bid_auction.cu, the rounds over
// per-pod shortlists). Both run the JAX package's whole while_loop in one
// cooperative launch: minisched_tpu/ops/auction.py:104-253 and
// minisched_tpu/ops/bid_select.py:76-210.
//
// Launch: one block of kThreads per SM (fewer for a small batch), every
// block resident. Pod p belongs to block p % G for the whole launch. A
// round is three phases between grid barriers:
//
//   control + nodes (no barrier between them): every block recomputes the
//       loop state from device memory, the same on every block (the last
//       round's progress flag, the stale count, whether the band has an
//       unassigned feasible pod left, the next band, the round budget),
//       then the smallest request of the band's bidders on each axis; then
//       the grid walks the nodes: prices reset when the band advanced, the
//       node's winner key cleared, and the round's open price written (the
//       price of a node whose free capacity covers that smallest request,
//       NaN for a closed node).
//   bids: each block takes its active pods one at a time; the whole block
//       reduces the pod's values (score - open price) to the best, its
//       first column and the best over the other columns (the bid
//       functor: the full row, or the shortlist with its certificate and
//       repair); thread 0 forms the bid: gamma = (v_best - v2 or 0) + eps,
//       strength = fma(noise(seed, round, pod), eps / 2, v_best), and the
//       64-bit key (strength's total-order key << 32 | pod), and raises the
//       node's winner key with one atomicMax.
//   winners: one thread per pod of the block: the pod whose key is its
//       node's winner key is the node's one winner (argsort(argsort(.)) of
//       the JAX package, which is stable, ranks ties by row); if its
//       request fits the node's free row (read before any debit of the
//       round: only the winner touches it) it takes the node and debits it
//       with one IEEE subtraction per axis; the price rises by its gamma
//       either way (one IEEE addition). Both equal the JAX package's
//       one-hot matmuls, which add one winner per node.
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
constexpr int kMaxP = 32 * kThreads;  // open_nodes: 32 pods per thread
constexpr int kStale = 8;
constexpr int kNegBand = -2147483647;  // -(2^31) + 1: no band left
constexpr int kNoLaunch = -1;           // no cudaError_t is negative
constexpr float kNeg = -3.0e38f;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;

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
  int32_t* best;                  // (P,)
  float* gamma;                   // (P,)
  unsigned long long* bid;        // (P,) 0: no bid this round
  float* s_vals;                  // (P,K) shortlist only
  int32_t* cand;                  // (P,K) shortlist only
  float* kth;                     // (P,) shortlist only
  int cache_keys;                 // shortlist: the row's keys fit in the
                                  // block's dynamic shared memory
  unsigned int* bar;              // grid barrier arrivals
  int* progress;                  // (2,) some winner fit, by round parity
};

// Bytes of scratch a launch needs, and their layout (16-byte aligned).
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~15; }

inline size_t scratch_bytes(int P, int N, int K) {
  size_t b = 0;
  b += align16(4ull * N) * 2 + align16(8ull * N);              // nodes
  b += align16(P) + align16(4ull * P) * 2 + align16(8ull * P);  // pods
  b += align16(4ull * P * K) * 2 + align16(4ull * P);           // shortlist
  b += 16 + 16;                                                 // barrier
  return b;
}

inline void carve(Params& p, void* scratch) {
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
  p.best = reinterpret_cast<int32_t*>(take(4 * P));
  p.gamma = reinterpret_cast<float*>(take(4 * P));
  p.bid = reinterpret_cast<unsigned long long*>(take(8 * P));
  p.s_vals = reinterpret_cast<float*>(take(4 * P * K));
  p.cand = reinterpret_cast<int32_t*>(take(4 * P * K));
  p.kth = reinterpret_cast<float*>(take(4 * P));
  p.bar = reinterpret_cast<unsigned int*>(take(16));
  p.progress = reinterpret_cast<int*>(take(16));
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

__device__ __forceinline__ Top2 top2_merge(const Top2& a, const Top2& b) {
  if (b.v > a.v || (b.v == a.v && b.col < a.col))
    return Top2{b.v, b.col, fmaxf(b.v2, a.v)};
  return Top2{a.v, a.col, fmaxf(a.v2, b.v)};
}

__device__ __forceinline__ Top2 top2_shfl(const Top2& t, int o) {
  return Top2{__shfl_xor_sync(kFull, t.v, o), __shfl_xor_sync(kFull, t.col, o),
              __shfl_xor_sync(kFull, t.v2, o)};
}

// The block's Top2, returned to every thread.
__device__ Top2 block_top2(Top2 t) {
  __shared__ Top2 warp_t[kWarps];
  __shared__ Top2 result;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = top2_merge(t, top2_shfl(t, o));
  if (lane == 0) warp_t[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lane < kWarps ? warp_t[lane] : top2_empty();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t = top2_merge(t, top2_shfl(t, o));
    if (lane == 0) result = t;
  }
  __syncthreads();
  t = result;
  __syncthreads();
  return t;
}

// The dense round's value of (row, col): the folded score less the open
// price, NEG where the pair is infeasible or the node closed.
__device__ __forceinline__ float value(const Params& p, float s, int row,
                                       int col) {
  const float f = fold(s, p.seed, row, col, p.eps);
  const float op = __ldcg(p.open_price + col);
  return (f > kNeg && op == op) ? __fsub_rn(f, op) : kNeg;
}

// The dense round's Top2 of pod `row` over its whole row (every thread of
// the block calls it; every thread gets the result).
__device__ Top2 dense_top2(const Params& p, int row) {
  Top2 t = top2_empty();
  const float* srow = p.scores + static_cast<size_t>(row) * p.N;
  if ((p.N & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    const int n4 = p.N >> 2;
    for (int i = threadIdx.x; i < n4; i += 2 * kThreads) {
      const int j = i + kThreads;
      const float4 a = __ldg(s4 + i);
      const float4 b = j < n4 ? __ldg(s4 + j) : make_float4(kNeg, kNeg, kNeg,
                                                           kNeg);
      const int c = 4 * i, d = 4 * j;
      top2_add(t, value(p, a.x, row, c), c);
      top2_add(t, value(p, a.y, row, c + 1), c + 1);
      top2_add(t, value(p, a.z, row, c + 2), c + 2);
      top2_add(t, value(p, a.w, row, c + 3), c + 3);
      if (j < n4) {
        top2_add(t, value(p, b.x, row, d), d);
        top2_add(t, value(p, b.y, row, d + 1), d + 1);
        top2_add(t, value(p, b.z, row, d + 2), d + 2);
        top2_add(t, value(p, b.w, row, d + 3), d + 3);
      }
    }
  } else {
    for (int c = threadIdx.x; c < p.N; c += kThreads)
      top2_add(t, value(p, __ldg(srow + c), row, c), c);
  }
  return block_top2(t);
}

// Every block's copy of the loop state (the same values on every block).
struct Loop {
  int band;
  int stale;
  int rnd;
  bool reset;  // the band advanced: prices restart at 0
};

// max over pods of f(pod), every thread of the block gets it.
template <typename F>
__device__ int block_max_pods(const Params& p, F f) {
  __shared__ int m;
  if (threadIdx.x == 0) m = kNegBand;
  __syncthreads();
  int v = kNegBand;
  for (int i = threadIdx.x; i < p.P; i += kThreads) v = max(v, f(i));
  v = __reduce_max_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) atomicMax(&m, v);
  __syncthreads();
  v = m;
  __syncthreads();
  return v;
}

__device__ __forceinline__ bool live(const Params& p, int i) {
  return __ldcg(p.chosen + i) < 0 && __ldcg(p.feasible + i);
}

// After a round: the stale count, the band control and the round count,
// as the JAX body's tail computes them.
__device__ void advance(const Params& p, Loop& s) {
  const int prog = __ldcg(p.progress + (s.rnd & 1));
  s.stale = prog ? 0 : s.stale + 1;
  const int band = s.band;
  bool left = false;
  for (int i = threadIdx.x; i < p.P; i += kThreads)
    left |= live(p, i) && __ldg(p.prio + i) == band;
  left = __syncthreads_or(left);
  s.reset = !left || s.stale >= kStale;
  if (s.reset) {
    s.band = block_max_pods(p, [&](int i) {
      const int pr = __ldg(p.prio + i);
      return live(p, i) && pr < band ? pr : kNegBand;
    });
    s.stale = 0;
  }
  s.rnd += 1;
}

// The control and node phase of a round: the smallest request of the
// band's bidders per axis, then each node's prices, winner key and open
// price.
__device__ void open_nodes(const Params& p, const Loop& s) {
  __shared__ uint32_t min_key[kMaxR];
  __shared__ float min_req[kMaxR];
  const uint32_t inf_key = 0xff800000u;  // float_key(+inf)
  if (threadIdx.x < p.R) min_key[threadIdx.x] = inf_key;
  // The band's bidders among this thread's pods, read once: bit j for
  // pod threadIdx.x + j * kThreads (a batch has at most kMaxP pods).
  uint32_t mine = 0;
  for (int j = 0, i = threadIdx.x; i < p.P; ++j, i += kThreads)
    if (live(p, i) && __ldg(p.prio + i) == s.band) mine |= 1u << j;
  __syncthreads();
  for (int r = 0; r < p.R; ++r) {
    uint32_t k = inf_key;
    for (uint32_t m = mine; m; m &= m - 1) {
      const int i = threadIdx.x + (__ffs(m) - 1) * kThreads;
      k = min(k, float_key(__ldg(p.req + static_cast<size_t>(i) * p.R + r)));
    }
    k = __reduce_min_sync(kFull, k);
    if ((threadIdx.x & 31) == 0) atomicMin(&min_key[r], k);
  }
  __syncthreads();
  if (threadIdx.x < p.R)
    min_req[threadIdx.x] = key_float(min_key[threadIdx.x]);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) p.progress[s.rnd & 1] = 0;
  const float nan = __uint_as_float(0x7fffffffu);
  for (int n = blockIdx.x * kThreads + threadIdx.x; n < p.N;
       n += gridDim.x * kThreads) {
    float price = __ldcg(p.prices + n);
    if (s.reset) {
      price = 0.0f;
      p.prices[n] = 0.0f;
    }
    p.node_key[n] = 0ull;
    bool open = true;
    for (int r = 0; r < p.R; ++r)
      open &= __ldcg(p.free + static_cast<size_t>(n) * p.R + r) >= min_req[r];
    p.open_price[n] = open ? price : nan;
  }
}

// The winners phase for the block's pods, one thread each.
__device__ void settle(const Params& p, const Loop& s) {
  for (int i = blockIdx.x + threadIdx.x * gridDim.x; i < p.P;
       i += kThreads * gridDim.x) {
    const unsigned long long key = __ldcg(p.bid + i);
    if (!key) continue;
    const int b = __ldcg(p.best + i);
    if (__ldcg(p.node_key + b) != key) continue;  // another pod won b
    float* fr = p.free + static_cast<size_t>(b) * p.R;
    const float* rq = p.req + static_cast<size_t>(i) * p.R;
    bool fits = true;
    for (int r = 0; r < p.R; ++r) fits &= __ldcg(fr + r) >= __ldg(rq + r);
    if (fits) {
      for (int r = 0; r < p.R; ++r)
        fr[r] = __fsub_rn(__ldcg(fr + r), __ldg(rq + r));
      p.chosen[i] = b;
      p.progress[s.rnd & 1] = 1;
    }
    p.prices[b] = __fadd_rn(__ldcg(p.prices + b), __ldcg(p.gamma + i));
  }
}

// The whole banded loop, after the kernel's own set-up (chosen = -1, free
// = free0, feasible known, behind a grid barrier). `bid(pod)` is called by
// every thread of the block for each active pod and returns its Top2.
template <typename Bid>
__device__ void run_rounds(const Params& p, unsigned& target, Bid bid) {
  Loop s{0, 0, 0, true};
  s.band = block_max_pods(p, [&](int i) {
    return __ldcg(p.feasible + i) ? __ldg(p.prio + i) : kNegBand;
  });
  while (s.rnd < p.max_rounds && s.band > kNegBand) {
    open_nodes(p, s);
    grid_sync(p.bar, target);
    // The block's pods, kThreads at a time: each thread checks one, and
    // the active ones are bid one after another by the whole block. An
    // infeasible pod's values are all NEG: it cannot bid (and its
    // shortlist is its row, so it is certified), so it is skipped.
    for (int base = 0; blockIdx.x + base * gridDim.x < p.P; base += kThreads) {
      __shared__ int list[kThreads];
      __shared__ int n_list;
      if (threadIdx.x == 0) n_list = 0;
      __syncthreads();
      const int mine = blockIdx.x + (base + threadIdx.x) * gridDim.x;
      if (mine < p.P) {
        if (live(p, mine) && __ldg(p.prio + mine) == s.band)
          list[atomicAdd(&n_list, 1)] = mine;
        else
          p.bid[mine] = 0ull;
      }
      __syncthreads();
      const int n = n_list;
      for (int j = 0; j < n; ++j) {
        const int i = list[j];
        const Top2 t = bid(i);
        if (threadIdx.x == 0) {
          unsigned long long key = 0ull;
          if (t.v > kNeg) {
            const float margin =
                t.v2 > kNeg ? __fsub_rn(t.v, t.v2) : 0.0f;
            const float g = __fadd_rn(margin, p.eps);
            const float strength =
                __fmaf_rn(noise(p.seed, s.rnd, i), p.half_eps, t.v);
            key = static_cast<unsigned long long>(float_key(strength)) << 32 |
                  static_cast<uint32_t>(i);
            p.best[i] = t.col;
            p.gamma[i] = g;
            atomicMax(p.node_key + t.col, key);
          }
          p.bid[i] = key;
        }
      }
      __syncthreads();  // the list is rewritten for the next kThreads
    }
    grid_sync(p.bar, target);
    settle(p, s);
    grid_sync(p.bar, target);
    advance(p, s);
  }
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.P;
       i += gridDim.x * kThreads)
    p.assigned[i] = __ldcg(p.chosen + i) >= 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) p.rounds[0] = s.rnd;
}

// The set-up every launch shares: chosen = -1, free = free0 (grid-wide).
__device__ void init_state(const Params& p) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int step = gridDim.x * kThreads;
  for (int i = t; i < p.P; i += step) p.chosen[i] = -1;
  const size_t nr = static_cast<size_t>(p.N) * p.R;
  for (size_t i = t; i < nr; i += step) p.free[i] = p.free0[i];
}

// Launch `kernel` cooperatively on `p` (scratch already carved) with
// `smem` bytes of dynamic shared memory; returns the launch's cudaError_t.
inline int launch(const void* kernel, Params& p, cudaStream_t st,
                  size_t smem = 0) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // A block per pod row up to one per SM, and enough for the node walk.
  int want = p.P > (p.N + kThreads - 1) / kThreads
                 ? p.P
                 : (p.N + kThreads - 1) / kThreads;
  const int nblocks = want < sms ? (want > 0 ? want : 1) : sms;
  err = cudaMemsetAsync(p.bar, 0, 32, st);  // the barrier and progress
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks and the empty batch shared by both entry points: returns
// kNoLaunch after copying free0 when there is no pod, an error for bad
// sizes, or 0 to go on.
inline int prelude(const Params& p, cudaStream_t st) {
  if (p.N < 1 || p.P < 0 || p.P > kMaxP || p.R < 1 || p.R > kMaxR ||
      p.K < 0 || p.K > p.N)
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
