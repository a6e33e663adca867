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
// at 3.35 TB/s, and later rounds only the losers' rows. The kernel keeps
// the whole loop on the card (no host read per round): two grid barriers
// per round (three when the nodes are walked), each a few microseconds
// with one block per SM.
//
// Design. The tie noise is folded into a score where it is read (the
// noise lattice is a few integer operations), so no (P,N) folded copy is
// kept: that saves a 218 MB write and reads no more bytes per round. The
// row scan streams float4 loads, two per thread in flight. Feasibility
// (any score above NEG) is found once per row with an early exit.
//
// Interface: a plain C function that launches on the caller's stream and
// returns the launch's cudaError_t, or kNoLaunch (-1) for an empty batch
// (free0 copied to free_after, rounds 0). It allocates nothing: the caller
// passes the outputs and auction_scratch_bytes(P, N) bytes of scratch.

#include "auction_rounds.cuh"

using namespace auction;

__global__ void __launch_bounds__(kThreads, 1) auction_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Local L = carve_local(p, smem);
  unsigned target = 0;
  init_state(p);
  for (int i = blockIdx.x; i < p.P; i += gridDim.x) {
    const float* srow = p.scores + static_cast<size_t>(i) * p.N;
    bool any = false;
    for (int c = threadIdx.x; c < p.N && !any; c += kThreads)
      any = __ldg(srow + c) > kNeg;
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) p.feasible[i] = any;
  }
  __syncthreads();
  init_local(p, L);
  // The block's active pods one after another, each over its full row.
  run_rounds(p, L, target, [&](const Loop& s) {
    for (int j = 0; j < L.n; ++j) {
      if (L.chosen[j] >= 0 || L.prio[j] != s.band) {
        if (threadIdx.x == 0) L.key[j] = 0ull;
        continue;
      }
      const int i = pod_of(j);
      const Top2 t = dense_top2(p, i);
      if (threadIdx.x == 0) post_bid(p, L, j, i, t, s.rnd);
    }
  });
}

extern "C" long long auction_scratch_bytes(int P, int N) {
  return static_cast<long long>(scratch_bytes(P, N, 0));
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
  carve(p, scratch);
  const void* kernel = reinterpret_cast<const void*>(auction_kernel);
  int sms = 0;
  size_t budget = 0;
  const int err = device_limits(kernel, &sms, &budget);
  if (err != 0) return err;
  const int nblocks = grid_for(p, sms);
  p.local = (P + nblocks - 1) / nblocks;
  if (local_bytes(p.local) > budget) return cudaErrorInvalidConfiguration;
  return launch(kernel, p, st, nblocks, local_bytes(p.local));
}

extern "C" const char* auction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
