// The certified shortlist scan of one scheduling batch, for Hopper.
//
// Replaces the sequential stage of minisched_tpu/ops/select.py
// greedy_assign_shortlist (its lax.scan, select.py:238-279; not a Pallas
// kernel, an XLA scan). Same function, bit for bit. The parallel part,
// shortlist_select (two top-k passes over the noise lattice), stays PyTorch
// ops in ops/select.py and hands this kernel, per pod, K candidate columns
// with their scores and the bound (kth, kth_noise).
//
// Pods are taken in row order. For pod i:
//   1. gather the candidates' free rows; a candidate fits when its free
//      row covers the request on every axis;
//   2. among fitting candidates: m = the largest score, wn = the largest
//      tie noise at m, win = the smallest column at (m, wn);
//   3. the certificate m > kth, or m == kth and wn > kth_noise, or
//      kth <= NEG, proves win is the full row's winner (every node outside
//      the shortlist is lexicographically at most (kth, kth_noise));
//   4. when it fails, repair: the same rule over all N columns of the row,
//      the math of greedy_assign.cu, and mark the pod repaired;
//   5. a winner whose score is above NEG is assigned and its free row is
//      debited with one IEEE subtraction per axis (__fsub_rn).
// With no fitting candidate above NEG the certificate reduces to
// kth <= NEG: then the pod is not assigned, else it repairs.
//
// Bound. At the main path's shape (P=1024, K=128, R=10, N=53248) the bytes
// the scan must move are the candidates and their scores (2 * P*K*4 B), the
// P*K*R gathered free values (5.2 MB) and free in and out (2 * 2.1 MB):
// about 10.6 MB, 3 us at 3.35 TB/s. The real limit is the chain: pod i+1's
// gather reads the row pod i debited, so the P steps run one after another,
// each a gather from L2 plus a warp reduction.
//
// Layout. One block of kThreads. The first kGroup threads (four warps)
// walk the pods, one candidate per thread: each loads its candidate's free
// row (all R loads in flight at once), forms its (score, noise, column)
// key, and the four warps' bests meet in shared memory at a named barrier;
// every group thread then reads the same winner and certificate. The
// thread holding the winner debits its row from the values it loaded, and
// a second named barrier orders that store before the next pod's gather.
// Pod i+1's candidate, score, bound and request are loaded into registers
// while pod i runs, so each step's only dependent device-memory access is
// the gather (one L2 round trip). free_after lives in device memory (a
// copy of free0 made on the stream before the launch; free0 itself is
// never written: the caller may still hold it). The other warps wait at a
// named barrier and join only a repair: the group posts the pod, all
// kThreads scan the row from device memory (two rows per thread in
// flight), reduce through shared memory, and one thread debits. K above
// kGroup loops over the candidates from device memory and debits by
// reading the winner's row again.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/shortlist_timing.py,
// PERF.md): 1.50 ms at the main path's shape (1.46-1.50 us per pod), against
// 3.17 ms for a first version in which warp 0 alone walked the pods (four
// candidates per lane, each row's loads one after another) in the same
// call. The step is about two L2 round trips (the debit's store made
// visible at the barrier, then the next gather) plus two named barriers.
// A repair costs about 70 us: one block reading 2.3 MB from L2.
//
// ptxas (sm_90a): the R <= 16 build 118 registers, no spills; the R <= 32
// build 128 registers, 176 bytes spilled.
//
// Exactness. Scores compare as order-preserving u32 keys (-0 mapped to +0,
// which float compare calls equal), the noise as its 24-bit integer
// x >> 8, which orders as the float (x >> 8) * 2^-24; the certificate
// compares wn as that float with kth_noise. Nothing is contracted to FMA:
// the only float arithmetic is the __fsub_rn debit.
//
// Interface: a plain C function that launches on the caller's stream and
// returns the cudaError_t of the launch, or kNoLaunch (-1) for an empty
// batch, where it only copies free0 into free_after. It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 128;  // threads that walk the pods: one candidate each
constexpr int kGroupWarps = kGroup / 32;
constexpr int kMaxR = 32;  // the kernel is built for R <= 16 and R <= 32
constexpr float kNeg = -3.0e38f;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;

// Named barriers (0 is __syncthreads). kBarPost: the group posts a pod to
// repair (or the end) and every warp meets there. kBarRepair: the block's
// partial bests are in shared memory; then the debit has landed. Among the
// group only: kBarStep, the request row and the last debit are visible;
// kBarBest, the group's partial bests are in shared memory.
constexpr int kBarPost = 1;
constexpr int kBarRepair = 2;
constexpr int kBarStep = 3;
constexpr int kBarBest = 4;

struct Best {
  uint32_t skey;
  uint32_t nkey;
  uint32_t col;
};

constexpr Best kEmpty{0u, 0u, 0xffffffffu};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t noise_key(uint32_t seed, uint32_t row,
                                              uint32_t col) {
  return fmix32(col * kColMult + seed + row * kGolden) >> 8;
}

// Every float maps above 0, so skey 0 marks "no candidate".
__device__ __forceinline__ uint32_t score_key(float s) {
  uint32_t u = s == 0.0f ? 0u : __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  if (a.skey != b.skey) return a.skey > b.skey;
  if (a.nkey != b.nkey) return a.nkey > b.nkey;
  return a.col < b.col;
}

__device__ __forceinline__ Best warp_best(const Best& t) {
  const uint32_t s = __reduce_max_sync(kFull, t.skey);
  const uint32_t n = __reduce_max_sync(kFull, t.skey == s ? t.nkey : 0u);
  const uint32_t c = __reduce_min_sync(
      kFull, t.skey == s && t.nkey == n ? t.col : 0xffffffffu);
  return Best{s, n, c};
}

__device__ __forceinline__ void bar_sync(int id, int count = kThreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Load column c's free row into v (all R loads issued before any is used;
// MaxR is R's compile-time bound). free is read with plain loads: the block
// writes it, so the non-coherent read-only path must not be used.
template <int MaxR>
__device__ __forceinline__ void load_row(float (&v)[MaxR], const float* free,
                                         uint32_t c, int R) {
  const float* f = free + static_cast<size_t>(c) * R;
#pragma unroll
  for (int r = 0; r < MaxR; ++r)
    if (r < R) v[r] = f[r];
}

// Does the row cover the request (in shared memory)?
template <int MaxR>
__device__ __forceinline__ bool covers(const float (&v)[MaxR],
                                       const float* req, int R) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < MaxR; ++r)
    if (r < R) ok &= v[r] >= req[r];
  return ok;
}

template <int MaxR>
__device__ __forceinline__ void consider(Best& best, const float (&v)[MaxR],
                                         const float* req, int R,
                                         uint32_t seed, uint32_t i,
                                         uint32_t c, float s) {
  if (covers<MaxR>(v, req, R)) {
    const Best t{score_key(s), noise_key(seed, i, c), c};
    if (better(t, best)) best = t;
  }
}

// The best of the first n partials in shared memory (the same in every
// thread that reads them).
__device__ __forceinline__ Best best_of(const Best* part, int n) {
  Best b = part[0];
  for (int k = 1; k < n; ++k)
    if (better(part[k], b)) b = part[k];
  return b;
}

// The full-row pick for pod i by the whole block (every thread calls it
// after kBarPost). Each thread keeps two rows' loads in flight. Returns the
// block's best, the same in every thread.
template <int MaxR>
__device__ Best repair_pick(const float* scores, const float* free,
                            const float* req, Best* part, uint32_t seed,
                            int i, int N, int R) {
  const int tid = threadIdx.x;
  const float* srow = scores + static_cast<size_t>(i) * N;
  Best t = kEmpty;
  float v0[MaxR], v1[MaxR];
  for (int j = tid; j < N; j += 2 * kThreads) {
    const int j1 = j + kThreads;
    load_row<MaxR>(v0, free, j, R);
    const float s0 = srow[j];
    float s1 = 0.f;
    if (j1 < N) {
      load_row<MaxR>(v1, free, j1, R);
      s1 = srow[j1];
    }
    consider<MaxR>(t, v0, req, R, seed, i, j, s0);
    if (j1 < N) consider<MaxR>(t, v1, req, R, seed, i, j1, s1);
  }
  const Best w = warp_best(t);
  if ((tid & 31) == 0) part[tid >> 5] = w;
  bar_sync(kBarRepair);
  return best_of(part, kWarps);
}

template <int MaxR>
__global__ void __launch_bounds__(kThreads, 1)
    shortlist_scan_kernel(const float* __restrict__ scores,
                          const int32_t* __restrict__ cand,
                          const float* __restrict__ cand_scores,
                          const float* __restrict__ kth,
                          const float* __restrict__ kth_noise,
                          const float* __restrict__ requests, float* free,
                          uint32_t seed, int P, int N, int K, int R,
                          int32_t* __restrict__ chosen,
                          uint8_t* __restrict__ assigned,
                          uint8_t* __restrict__ repaired) {
  // The request row, by pod parity: the winner's thread may still debit
  // pod i from it while warp 0 writes pod i+1's.
  __shared__ float s_req[2][MaxR];
  __shared__ Best s_part[kWarps];
  __shared__ int s_pod;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint32_t kneg = score_key(kNeg);

  if (tid >= kGroup) {
    // Helper warps: join each posted repair until the group posts the end.
    while (true) {
      bar_sync(kBarPost);
      const int i = s_pod;
      if (i < 0) return;
      repair_pick<MaxR>(scores, free, s_req[i & 1], s_part, seed, i, N, R);
      bar_sync(kBarRepair);  // the debit
    }
  }

  // The group. Registers hold the next pod's inputs (prefetch).
  const bool in_regs = K <= kGroup;
  int nc = -1;
  float ns = 0.f, nreq = 0.f, nkth = 0.f, nkthn = 0.f;
  auto prefetch = [&](int i) {
    if (i >= P) return;
    if (in_regs && tid < K) {
      nc = cand[static_cast<size_t>(i) * K + tid];
      ns = cand_scores[static_cast<size_t>(i) * K + tid];
    }
    if (tid < R) nreq = requests[static_cast<size_t>(i) * R + tid];
    nkth = kth[i];
    nkthn = kth_noise[i];
  };
  prefetch(0);

  float v[MaxR];
  for (int i = 0; i < P; ++i) {
    const int c = nc;
    const float cs = ns, kth_i = nkth, kthn_i = nkthn;
    float* req = s_req[i & 1];
    if (tid < R) req[tid] = nreq;
    bar_sync(kBarStep, kGroup);  // the request row and the last debit
    prefetch(i + 1);

    Best best = kEmpty;
    if (in_regs) {
      if (c >= 0) {
        load_row<MaxR>(v, free, c, R);
        consider<MaxR>(best, v, req, R, seed, i, c, cs);
      }
    } else {
      float u[MaxR];
      for (int k = tid; k < K; k += kGroup) {
        const uint32_t ck = cand[static_cast<size_t>(i) * K + k];
        load_row<MaxR>(u, free, ck, R);
        consider<MaxR>(best, u, req, R, seed, i, ck,
                 cand_scores[static_cast<size_t>(i) * K + k]);
      }
    }
    const Best wb = warp_best(best);
    if (lane == 0) s_part[tid >> 5] = wb;
    bar_sync(kBarBest, kGroup);
    Best w = best_of(s_part, kGroupWarps);
    bool ok = w.skey > kneg;
    bool certified = kth_i <= kNeg;
    if (ok && !certified) {
      const uint32_t kk = score_key(kth_i);
      const float wn = static_cast<float>(w.nkey) * (1.0f / 16777216.0f);
      certified = w.skey > kk || (w.skey == kk && wn > kthn_i);
    }
    if (certified && in_regs) {
      // The winner's thread debits from the row it loaded.
      if (ok && static_cast<uint32_t>(c) == w.col) {
        float* f = free + static_cast<size_t>(w.col) * R;
#pragma unroll
        for (int r = 0; r < MaxR; ++r)
          if (r < R) f[r] = __fsub_rn(v[r], req[r]);
      }
    } else {
      if (!certified) {
        if (tid == 0) s_pod = i;
        bar_sync(kBarPost);
        w = repair_pick<MaxR>(scores, free, req, s_part, seed, i, N, R);
        ok = w.skey > kneg;
      }
      if (ok && tid < R) {
        float* f = free + static_cast<size_t>(w.col) * R + tid;
        *f = __fsub_rn(*f, req[tid]);
      }
      if (!certified) bar_sync(kBarRepair);
    }
    if (tid == 0) {
      chosen[i] = ok ? static_cast<int32_t>(w.col) : -1;
      assigned[i] = ok;
      repaired[i] = !certified;
    }
  }
  if (tid == 0) s_pod = -1;
  bar_sync(kBarPost);
}

}  // namespace

extern "C" int shortlist_scan_launch(const float* scores, const int32_t* cand,
                                     const float* cand_scores, const float* kth,
                                     const float* kth_noise,
                                     const float* requests, const float* free0,
                                     uint32_t seed, int P, int N, int K, int R,
                                     int32_t* chosen, uint8_t* assigned,
                                     float* free_after, uint8_t* repaired,
                                     void* stream) {
  if (N < 1 || P < 0 || K < 1 || K > N || R < 1 || R > kMaxR)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(free_after, free0, sizeof(float) * N * R,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  if (P == 0) return kNoLaunch;
  if (R <= 16)
    shortlist_scan_kernel<16><<<1, kThreads, 0, st>>>(
        scores, cand, cand_scores, kth, kth_noise, requests, free_after, seed,
        P, N, K, R, chosen, assigned, repaired);
  else
    shortlist_scan_kernel<kMaxR><<<1, kThreads, 0, st>>>(
        scores, cand, cand_scores, kth, kth_noise, requests, free_after, seed,
        P, N, K, R, chosen, assigned, repaired);
  return cudaGetLastError();
}

extern "C" const char* shortlist_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
