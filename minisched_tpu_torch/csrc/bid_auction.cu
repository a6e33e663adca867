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
// pod's full row. The rounds are bound by their three grid barriers and
// the control phase each block recomputes, not by bytes.
//
// Design. The selection is an MSB-first radix select per row (one block a
// row): four passes of 8 bits find the K-th largest total-order key T and
// how many keys equal to T the set takes (the lowest columns); a fifth
// pass collects the keys above T in any order and the ties at T in column
// order (a block-wide prefix count per chunk of columns). The order inside
// a shortlist is not needed: every round's reduction (max, lowest tied
// column, best of the rest) is order-free, and when the set takes every
// key equal to T (distinct scores: the usual row) the fifth pass keeps no
// order at all. The histograms use
// warp-aggregated shared atomics (scores that share an exponent fall in a
// few bins). The row is read once, with float4 loads, and its folded keys
// are kept in dynamic shared memory for the passes (4N bytes: up to about
// 57,000 columns beside the kernel's static shared memory; a wider row
// folds its scores again in every pass, from L2 after the first).
//
// Interface: as csrc/auction.cu, plus K (1 <= K <= N) and the (P,)
// repaired output; bid_auction_scratch_bytes(P, N, K) bytes of scratch.

#include "auction_rounds.cuh"

using namespace auction;

namespace {

// The key of column c of `row`: from the block's shared cache, or the
// score folded again.
__device__ __forceinline__ uint32_t row_key(const Params& p, int row,
                                            const float* srow,
                                            const uint32_t* keys_s, int c) {
  if (p.cache_keys) return keys_s[c];
  return float_key(fold(__ldg(srow + c), p.seed, row, c, p.eps));
}

// Fill the block's key cache with the folded keys of `row`: float4 loads,
// two in flight per thread.
__device__ void cache_row(const Params& p, int row, const float* srow,
                          uint32_t* keys_s) {
  if ((p.N & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    const int n4 = p.N >> 2;
    for (int i = threadIdx.x; i < n4; i += 2 * kThreads) {
      const int j = i + kThreads;
      const float4 a = __ldg(s4 + i);
      float4 b = a;
      if (j < n4) b = __ldg(s4 + j);
      const float va[4] = {a.x, a.y, a.z, a.w};
      for (int q = 0; q < 4; ++q)
        keys_s[4 * i + q] =
            float_key(fold(va[q], p.seed, row, 4 * i + q, p.eps));
      if (j < n4) {
        const float vb[4] = {b.x, b.y, b.z, b.w};
        for (int q = 0; q < 4; ++q)
          keys_s[4 * j + q] =
              float_key(fold(vb[q], p.seed, row, 4 * j + q, p.eps));
      }
    }
  } else {
    for (int c = threadIdx.x; c < p.N; c += kThreads)
      keys_s[c] = float_key(fold(__ldg(srow + c), p.seed, row, c, p.eps));
  }
  __syncthreads();
}

// The shortlist of `row`: s_vals and cand (K entries, unordered), kth,
// feasible, and repaired cleared. Every thread of the block calls it.
__device__ void select_row(const Params& p, int row, uint32_t* keys_s) {
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_kk, s_eq, s_gt, s_eq_taken;
  __shared__ unsigned warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* srow = p.scores + static_cast<size_t>(row) * p.N;
  if (p.cache_keys) cache_row(p, row, srow, keys_s);
  const uint32_t neg_key = float_key(kNeg);
  unsigned prefix = 0, mask = 0, kk = static_cast<unsigned>(p.K);
  bool feas = false;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int b = threadIdx.x; b < 256; b += kThreads) hist[b] = 0;
    __syncthreads();
    // Every lane runs the same trip count, so the match is warp-wide.
    for (int base = 0; base < p.N; base += kThreads) {
      const int c = base + threadIdx.x;
      bool in = false;
      unsigned bin = 0;
      if (c < p.N) {
        const uint32_t u = row_key(p, row, srow, keys_s, c);
        feas |= u > neg_key;
        in = (u & mask) == prefix;
        bin = (u >> shift) & 255u;
      }
      const unsigned peers = __match_any_sync(kFull, in ? bin : 0xffffffffu);
      if (in && __ffs(peers) - 1 == lane) atomicAdd(&hist[bin], __popc(peers));
    }
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
            s_eq = h;
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
  feas = __syncthreads_or(feas);
  // prefix is T, the K-th largest key; the set takes every key above T
  // (K - kk of them) and the kk lowest columns whose key is T.
  // s_eq (the last pass's bin) counts the keys equal to T.
  const bool all_eq = s_eq == kk;
  if (threadIdx.x == 0) s_gt = s_eq_taken = 0;
  __syncthreads();
  const unsigned n_gt = static_cast<unsigned>(p.K) - kk;
  float* sv = p.s_vals + static_cast<size_t>(row) * p.K;
  int32_t* cd = p.cand + static_cast<size_t>(row) * p.K;
  if (all_eq) {
    // Every key equal to T is taken: no column order to keep.
    for (int c = threadIdx.x; c < p.N; c += kThreads) {
      const uint32_t u = row_key(p, row, srow, keys_s, c);
      if (u >= prefix) {
        const unsigned slot = u > prefix ? atomicAdd(&s_gt, 1u)
                                         : n_gt + atomicAdd(&s_eq_taken, 1u);
        sv[slot] = key_float(u);
        cd[slot] = c;
      }
    }
  }
  unsigned eq_base = 0;
  for (int base = 0; base < p.N && !all_eq; base += kThreads) {
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
    before += __popc(ball & ((1u << lane) - 1u));
    if (eq && before < kk) {
      sv[n_gt + before] = key_float(u);
      cd[n_gt + before] = c;
    }
    eq_base += total;
    const bool done = eq_base >= kk && s_gt == n_gt;
    __syncthreads();
    if (done) break;
  }
  if (threadIdx.x == 0) {
    p.kth[row] = key_float(prefix);
    p.feasible[row] = feas;
    p.repaired[row] = 0;
  }
  // The cache is rewritten for the block's next row.
  __syncthreads();
}

// The round's bid of `row` through its shortlist, repaired over the full
// row when the certificate fails.
__device__ Top2 shortlist_top2(const Params& p, int row) {
  const float* sv = p.s_vals + static_cast<size_t>(row) * p.K;
  const int32_t* cd = p.cand + static_cast<size_t>(row) * p.K;
  Top2 t = top2_empty();
  for (int j = threadIdx.x; j < p.K; j += kThreads) {
    const float v = __ldcg(sv + j);
    const int c = __ldcg(cd + j);
    const float op = __ldcg(p.open_price + c);
    top2_add(t, (v > kNeg && op == op) ? __fsub_rn(v, op) : kNeg, c);
  }
  t = block_top2(t);
  const float kth = __ldcg(p.kth + row);
  if ((t.v > kth && t.v2 >= kth) || kth <= kNeg) return t;
  if (threadIdx.x == 0) p.repaired[row] = 1;
  return dense_top2(p, row);
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1) bid_auction_kernel(Params p) {
  extern __shared__ uint32_t keys_s[];
  unsigned target = 0;
  init_state(p);
  for (int i = blockIdx.x; i < p.P; i += gridDim.x) select_row(p, i, keys_s);
  grid_sync(p.bar, target);
  run_rounds(p, target, [&](int i) { return shortlist_top2(p, i); });
}

extern "C" long long bid_auction_scratch_bytes(int P, int N, int K) {
  return static_cast<long long>(scratch_bytes(P, N, K));
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
  // Cache each row's keys in shared memory when the row fits beside the
  // kernel's static shared memory.
  const void* kernel = reinterpret_cast<const void*>(bid_auction_kernel);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t row_bytes = sizeof(uint32_t) * static_cast<size_t>(N);
  p.cache_keys =
      row_bytes + attr.sharedSizeBytes <= static_cast<size_t>(optin);
  return launch(kernel, p, st, p.cache_keys ? row_bytes : 0);
}

extern "C" const char* bid_auction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
