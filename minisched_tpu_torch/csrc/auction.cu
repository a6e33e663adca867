// The auction assignment's dense bidding rounds, for Hopper.
//
// Replaces the JAX package's auction_assign (minisched_tpu/ops/auction.py:
// 104-253, a lax.while_loop at :249, not a Pallas kernel): priority-banded
// non-displacing Bertsekas rounds over full (P,N) value rows, bit for bit.
// Every round each unassigned pod of the band bids on the best node of its
// row (noise-folded score less the node's price; NEG where infeasible or
// where the node cannot fit the band's smallest request), each node takes
// its strongest bidder, a winner that fits is debited, and the node's
// price rises by the winner's margin; the band advances when it is
// assigned or 8 rounds pass without an assignment. The rounds, the phases
// and the exactness argument are in auction_rounds.cuh.
//
// Bound. A round must read the active pods' score rows: at bench-50k the
// first round reads all of them, 1024 x 53248 floats, 218 MB, about 65 us
// at 3.35 TB/s, and later rounds only the losers' rows. Each score costs
// about 20 instructions (the tie noise's hash, its conversion, the fold,
// the price, the running top two): about 35 us of issue over 132 SMs in
// that first round, under its bytes. The kernel keeps the whole loop on
// the card (no host read per round): two grid barriers per round (three
// when the nodes are walked), each a few microseconds.
//
// Bids. The round's bid work is cut into (active pod, tile of kTile
// columns) units in list order, and each warp of the grid takes a
// contiguous range of them, floor or ceil of U / W: every warp streams
// the same bytes whatever the batch's split into blocks (a block no
// longer walks its own pods' rows alone). A warp requests a tile's
// scores with kDepth 16-byte loads a lane, folds the tie noise into each
// score where it is read (no (P,N) folded copy: that would write 218 MB
// to save no read), subtracts the open price (from the block's
// shared-memory copy of the round's open prices when the block's units
// read more price bytes than the copy costs, else from L2) and keeps its
// lanes' running top two in column order across the tiles of a pod
// (top2_add_dense). It requests the next tile's scores before it counts
// a finished pod in. A pod whose tiles span several warps gets one Top2
// from each warp's segment, posted to device memory and counted in with
// one acquire-release atomic for the segment's tiles: the warp that
// brings the count to the tile count merges the segments' Top2s (exact
// in any order; a slot no segment starts at holds the empty Top2) and
// posts the pod's bid. No block barrier and no grid barrier is added to
// the round.
//
// The active list: the blocks append their active pods to a list before
// the barrier that precedes the bids (auction_rounds.cuh, run_rounds).
// Feasibility (any score above NEG) is found once per row by a warp of its
// owner, with an early exit (a thread a row for rows of at most 32
// columns).
//
// Interface: a plain C function that launches on the caller's stream and
// returns the launch's cudaError_t, or kNoLaunch (-1) for an empty batch
// (free0 copied to free_after, rounds 0). It allocates nothing: the caller
// passes the outputs and auction_scratch_bytes(P, N) bytes of scratch.

#include "auction_rounds.cuh"

using namespace auction;

namespace {

constexpr int kTile = 1024;          // columns of a bid unit
constexpr int kDepth = kTile / 128;  // 16-byte loads a lane keeps in flight

inline size_t dense_bytes(int P, int N) {
  const size_t T = (static_cast<size_t>(N) + kTile - 1) / kTile;
  return T > 1 ? align16(16ull * P * T) + align16(4ull * P) : 0;
}

// Request the scores of pod i's columns [c0, c1): kDepth 16-byte loads a
// lane (rows of 16-byte aligned float4s; other rows load in tile_reduce).
__device__ __forceinline__ void tile_load(const Params& p, int i, int c0,
                                          int c1, float4 (&v)[kDepth]) {
  if (!p.vec) return;
  const int lane = threadIdx.x & 31;
  const float4* s4 = reinterpret_cast<const float4*>(
      p.scores + static_cast<size_t>(i) * p.N + c0);
  const int n4 = (c1 - c0) >> 2;
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const int q = lane + 32 * k;
    if (q < n4) v[k] = __ldg(s4 + q);
  }
}

// Pod i's columns [c0, c1) into this lane's running top two t (which
// holds only lower columns of the pod): the scores tile_load requested,
// the open prices from `ops` (shared memory) when kStaged, else from L2.
template <bool kStaged>
__device__ __forceinline__ void tile_reduce(const Params& p, const float* ops,
                                            int i, int c0, int c1,
                                            const float4 (&v)[kDepth],
                                            Top2& t) {
  const int lane = threadIdx.x & 31;
  const uint32_t hb = p.seed + static_cast<uint32_t>(i) * kGolden;
  if (p.vec) {
    const int n4 = (c1 - c0) >> 2;
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int q = lane + 32 * k;
      if (q < n4) {
        const int c = c0 + 4 * q;
        const float4 o =
            kStaged ? reinterpret_cast<const float4*>(ops)[c >> 2]
                    : __ldcg(reinterpret_cast<const float4*>(p.open_price) +
                             (c >> 2));
        top2_add_dense(t, v[k].x, o.x, c, hb, p.eps);
        top2_add_dense(t, v[k].y, o.y, c + 1, hb, p.eps);
        top2_add_dense(t, v[k].z, o.z, c + 2, hb, p.eps);
        top2_add_dense(t, v[k].w, o.w, c + 3, hb, p.eps);
      }
    }
    return;
  }
  const float* srow = p.scores + static_cast<size_t>(i) * p.N;
  for (int base = c0; base < c1; base += 32 * kDepth) {
    float s[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int c = base + lane + 32 * k;
      if (c < c1) s[k] = __ldg(srow + c);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int c = base + lane + 32 * k;
      if (c < c1)
        top2_add_dense(t, s[k], kStaged ? ops[c] : __ldcg(p.open_price + c),
                       c, hb, p.eps);
    }
  }
}

// A warp's segment of pod i, tiles [first, first + n), done with its Top2
// t (every lane holds it): the pod's bid is posted by the warp that
// counts the pod's last tile in, after merging every segment's Top2.
__device__ void finish_segment(const Params& p, const Pods<true>& L, int i,
                               int first, int n, Top2 t, int rnd) {
  const int lane = threadIdx.x & 31;
  if (n < p.tiles) {
    int4* part = p.part + static_cast<size_t>(i) * p.tiles;
    unsigned last = 0;
    if (lane == 0) {
      // The Top2 posted, then counted in with release and acquire at gpu
      // scope: the warp that counts the last tile sees every segment's.
      __stcg(part + first, make_int4(__float_as_int(t.v), t.col,
                                     __float_as_int(t.v2), 0));
      unsigned before;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
                   : "=r"(before)
                   : "l"(p.count + i), "r"(n)
                   : "memory");
      last = before + n == static_cast<unsigned>(p.tiles);
    }
    if (!__shfl_sync(kFull, last, 0)) return;
    __syncwarp();
    // Every segment's Top2 (the slots no segment starts at hold the empty
    // Top2), each slot emptied again for the next round.
    const int4 empty = make_int4(__float_as_int(kNeg), 0x7fffffff,
                                 __float_as_int(kNeg), 0);
    t = top2_empty();
    for (int x = lane; x < p.tiles; x += 32) {
      const int4 q = __ldcg(part + x);
      t = top2_merge(t, Top2{__int_as_float(q.x), q.y, __int_as_float(q.z)});
      __stcg(part + x, empty);
    }
    t = warp_top2(t);
    if (lane == 0) p.count[i] = 0u;
  }
  if (lane == 0) post_bid(p, L, i, i, t, rnd);
}

// The first of the U units (pod, tile) that warp w of W takes: every warp
// takes a contiguous range, floor or ceil of U / W units.
__device__ __forceinline__ unsigned range_start(unsigned w, unsigned U,
                                                unsigned W) {
  return static_cast<unsigned>(static_cast<unsigned long long>(w) * U / W);
}

// The round's bids: the units (active pod, tile) of the active list, in
// list order, a contiguous range for each warp of the grid; a warp keeps
// its running top two across the tiles of a pod and counts a pod in once
// for the tiles it covered (every thread of every block calls it).
__device__ void dense_bids(const Params& p, const Pods<true>& L,
                           const Loop& s, float* ops_s) {
  const unsigned A = __ldcg(list_count(p, s.rnd, s.reset));
  const unsigned T = static_cast<unsigned>(p.tiles);
  const unsigned U = A * T;
  const unsigned W = gridDim.x * kWarps;
  const unsigned first = blockIdx.x * kWarps;
  const unsigned mine = range_start(first + kWarps, U, W) -
                        range_start(first, U, W);
  if (mine == 0) return;  // the same on every thread of the block
  // The open prices are copied to shared memory when this block's units
  // would read more of them from L2.
  const bool staged = p.staged && static_cast<size_t>(mine) * kTile > p.N;
  if (staged) {
    if (p.vec) {
      const float4* g = reinterpret_cast<const float4*>(p.open_price);
      float4* o = reinterpret_cast<float4*>(ops_s);
      for (int x = threadIdx.x; x < (p.N >> 2); x += kThreads)
        o[x] = __ldcg(g + x);
    } else {
      for (int x = threadIdx.x; x < p.N; x += kThreads)
        ops_s[x] = __ldcg(p.open_price + x);
    }
    __syncthreads();
  }
  const unsigned warp = threadIdx.x >> 5;
  unsigned u = range_start(first + warp, U, W);
  const unsigned end = range_start(first + warp + 1, U, W);
  if (u >= end) return;
  // Pipelined: the next tile's pod is looked up while this tile is
  // reduced, and its scores are requested before this pod is counted in.
  unsigned a = u / T, tile = u - a * T, seg = tile;
  int i = __ldcg(p.act + a);
  float4 v[kDepth];
  tile_load(p, i, static_cast<int>(tile) * kTile,
            min(p.N, static_cast<int>(tile + 1) * kTile), v);
  Top2 t = top2_empty();
  for (;;) {
    const bool more = u + 1 < end;
    const unsigned na = tile + 1 == T ? a + 1 : a;
    const unsigned nt = tile + 1 == T ? 0 : tile + 1;
    const int ni = more && na != a ? __ldcg(p.act + na) : i;
    const int c0 = static_cast<int>(tile) * kTile;
    const int c1 = min(p.N, c0 + kTile);
    if (staged)
      tile_reduce<true>(p, ops_s, i, c0, c1, v, t);
    else
      tile_reduce<false>(p, nullptr, i, c0, c1, v, t);
    if (more)
      tile_load(p, ni, static_cast<int>(nt) * kTile,
                min(p.N, static_cast<int>(nt + 1) * kTile), v);
    if (!more || na != a) {
      finish_segment(p, L, i, static_cast<int>(seg),
                     static_cast<int>(tile - seg + 1), warp_top2(t), s.rnd);
      t = top2_empty();
      seg = 0;
    }
    if (!more) break;
    u += 1;
    a = na;
    tile = nt;
    i = ni;
  }
}

// Each of the block's rows: whether any score is above NEG, into
// p.feasible (a warp a row, or a thread a row when rows are narrow).
__device__ void feasible_rows(const Params& p, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (p.N <= 32) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int i = pod_of(j);
      const float* srow = p.scores + static_cast<size_t>(i) * p.N;
      bool any = false;
      for (int c = 0; c < p.N && !any; ++c) any = __ldg(srow + c) > kNeg;
      p.feasible[i] = any;
    }
    return;
  }
  for (int j = warp; j < n; j += kWarps) {
    const int i = pod_of(j);
    const float* srow = p.scores + static_cast<size_t>(i) * p.N;
    bool any = false;
    for (int c0 = 0; c0 < p.N && !any; c0 += kTile) {
      const int c1 = min(p.N, c0 + kTile);
      bool hit = false;
      if (p.vec) {
        const float4* s4 = reinterpret_cast<const float4*>(srow + c0);
        const int n4 = (c1 - c0) >> 2;
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          const int q = lane + 32 * k;
          if (q < n4) {
            const float4 v = __ldg(s4 + q);
            hit |= v.x > kNeg || v.y > kNeg || v.z > kNeg || v.w > kNeg;
          }
        }
      } else {
        for (int c = c0 + lane; c < c1; c += 32) hit |= __ldg(srow + c) > kNeg;
      }
      any = __any_sync(kFull, hit);
    }
    if (lane == 0) p.feasible[i] = any;
  }
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1)
    auction_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ops_s = reinterpret_cast<float*>(smem);
  const Pods<true> L = carve_pods<true>(p, smem);
  unsigned target = 0;
  init_state(p);
  if (p.tiles > 1) {
    const int4 empty = make_int4(__float_as_int(kNeg), 0x7fffffff,
                                 __float_as_int(kNeg), 0);
    const size_t slots = static_cast<size_t>(p.P) * p.tiles;
    for (size_t x = blockIdx.x * kThreads + threadIdx.x; x < slots;
         x += gridDim.x * kThreads) {
      p.part[x] = empty;
      if (x < static_cast<size_t>(p.P)) p.count[x] = 0u;
    }
  }
  feasible_rows(p, L.n);
  __syncthreads();
  init_local(p, L);
  run_rounds(p, L, target, true,
             [&](const Loop& s) { dense_bids(p, L, s, ops_s); });
}

extern "C" long long auction_scratch_bytes(int P, int N) {
  return static_cast<long long>(scratch_bytes(P, N, 0) + dense_bytes(P, N));
}

extern "C" int auction_launch(const float* scores, const float* requests,
                              const float* free0, const int32_t* priority,
                              uint32_t seed, float eps, float half_eps,
                              int max_rounds, int P, int N, int R,
                              int32_t* chosen, uint8_t* assigned,
                              float* free_after, int32_t* rounds,
                              void* scratch, void* stream) {
  Params p{};
  p.scores = scores;
  p.req = requests;
  p.free0 = free0;
  p.prio = priority;
  p.P = P;
  p.N = N;
  p.R = R;
  p.K = 0;
  p.seed = seed;
  p.eps = eps;
  p.half_eps = half_eps;
  p.max_rounds = max_rounds;
  p.chosen = chosen;
  p.assigned = assigned;
  p.free = free_after;
  p.rounds = rounds;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pre = prelude(p, st);
  if (pre != 0) return pre;
  char* rest = carve(p, scratch);
  p.tiles = (N + kTile - 1) / kTile;
  if (p.tiles > 1) {
    p.part = reinterpret_cast<int4*>(rest);
    p.count = reinterpret_cast<unsigned*>(
        rest + align16(16ull * P * p.tiles));
  }
  p.vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  const void* kernel = reinterpret_cast<const void*>(auction_kernel);
  int sms = 0;
  size_t budget = 0;
  const int err = device_limits(kernel, &sms, &budget);
  if (err != 0) return err;
  const int nblocks = grid_for(p, sms);
  p.local = (P + nblocks - 1) / nblocks;
  const size_t stage = align16(4ull * N);
  p.staged = stage <= budget;
  return launch(kernel, p, st, nblocks, p.staged ? stage : 0);
}

extern "C" const char* auction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
