// Capacity-aware greedy assignment of one scheduling batch, for Hopper.
//
// Replaces the TPU kernel minisched_tpu/ops/pallas_select.py:65 (_kernel)
// launched at :151 (greedy_assign_pallas). Same function, bit for bit:
// pods are taken in row order; for pod i, among the nodes whose free
// resources cover the pod's request on every axis, the winner is the
// largest score, then the largest tie noise tie_noise_from_cols(seed, i,
// col), then the smallest column. A winner whose score is above NEG is
// assigned and its node's free row is debited by the request.
//
// Bound. At the main path's shape (P=1024 pods, N=53248 nodes, R=10) the
// kernel must read the score matrix once, 1024*53248*4 B = 218 MB, about
// 65 us at 3.35 TB/s. But the work is a chain of 1024 dependent argmaxes:
// pod i+1 cannot choose before pod i's debit lands, and each argmax spans
// every SM. So the limit is one cross-SM exchange per pod, a store and a
// load through L2, not the bytes.
//
// Layout. One cooperative launch with one block per SM (fewer for small
// N). Block b owns a contiguous slice of node columns and keeps that
// slice's free rows in shared memory for the whole batch, transposed to
// [R][slice]. Warp 0 is the exchange warp; the other 15 warps scan. The
// design takes everything but the exchange off the chain:
//
// 1. HBM off the critical path. A ring of kStages stages in shared memory
//    holds the request row and the block's score slice of the next pods.
//    4-byte cp.async copies (any alignment, so odd N is fine) fill it six
//    pods ahead of use; the scan warps issue them after their scan, so the
//    scan's loads never queue behind fresh copies. The copies need about
//    0.15 TB/s.
//
// 2. Look-ahead local argmax with an exact owner fix-up. While pod i is
//    exchanged, the scan warps reduce the slice for pod i+1 against the
//    free rows as they stand, before pod i's debit. A debit changes one
//    row only, that of pod i's winner w, so the result is exact in every
//    block but the one owning w. Let F be the slice's columns that fit pod
//    i+1 before the debit, p the pending best over F, and F' the fitting
//    columns after it; F' and F differ at most in w.
//    (a) p.col == w and w no longer fits: p left F', the best of F' is
//        unknown, so the owner's scan warps rescan the slice from shared
//        memory before pod i+1 is published.
//    (b) w fits after the debit: if p.col != w, p is the best of F\{w}
//        and F' = F\{w} + {w}, so the best is better(p, triple(w)); if
//        p.col == w the triple is unchanged (scores do not depend on free)
//        and better() returns p.
//    (c) w fits neither after the debit nor is p: F' = F\{w} and p is in
//        it, so p stands.
//    Nothing assumes the sign of a request: a negative request raises
//    free, which is why w can join F' in (b).
//
// 3. A one-round tagged exchange. Each block's exchange warp publishes
//    its pending best for pod i as one 8-byte word in its slot: score key
//    << 32 | noise key << 8 | tag. A 64-bit store is single-copy atomic,
//    so a reader that sees the tag has an untorn value from one round
//    trip; no counter, no grid barrier. The slot's index is the block, and
//    slices are contiguous, so among equal score and noise the lowest
//    block holds the smallest column: the maximum of score << 32 | noise
//    << 8 | (255 - block) is the winner, and the owner alone needs the
//    column (it writes chosen[i]). Every exchange warp polls all slots,
//    keeping all its loads in flight, and reduces them with warp
//    reductions. Slots are double-buffered by pod parity; a block writes
//    pod i+2 only after reading pod i+1 from every block, each of which
//    wrote pod i+1 only after reading pod i, so a reader of pod i meets
//    pod i-2's value or pod i's, and their tags (i % 255 + 1) differ. The
//    launch zeroes the slots on the stream, and no tag is 0, so nothing
//    of an earlier launch matches. The payload is the tagged word itself,
//    so relaxed .gpu loads and stores suffice. The cooperative launch
//    stays: the polls end only if every block is resident.
//
// Within a block, named barriers replace __syncthreads on the chain: the
// scan warps arrive with their look-ahead partials, which the exchange
// warp waits for only after its poll; the exchange warp arrives after the
// debit, which the scan warps wait for before the next scan.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 1.68-1.85 ms at the
// main path's shape, against 4.98 ms for a grid barrier per pod in
// the same call; of about 1.8 us per pod, 1.6 us is the exchange (publish
// to the last slot seen). The look-ahead scan (about 1 us) hides under
// the exchange.
//
// Exactness. Scores compare as order-preserving u32 keys (with -0 mapped
// to +0, which float compare calls equal); the noise compares as its
// 24-bit integer x >> 8, which orders exactly as the float
// (x >> 8) * 2^-24. The debit is one IEEE subtraction (__fsub_rn, which
// nvcc never contracts), matching free.at[row].add(-req).
//
// Shared memory: free slice R*slice*4 B plus the ring kStages*slice*4 B
// (at the main path 16,160 + 12,928 B) plus 1,424 B static. With the ring
// a block holds (R+8)*slice*4 B within 227 KB: N up to about 420k nodes
// at R=10. Beyond that the ring keeps only the request rows and the scan
// reads its scores from device memory, so the limit stays that of the
// free slices alone, R*slice*4 B: about 760k nodes at R=10. Past it the
// launch is refused with cudaErrorInvalidConfiguration.
//
// ptxas (sm_90a, -Xptxas -v on the card): 72 registers, 0 bytes spilled,
// 1,424 bytes of static shared memory, for both instantiations.
//
// Interface: a plain C function that launches on the caller's stream and
// returns the cudaError_t of the launch, or kNoLaunch (-1) for an empty
// batch, where it only copies free0 into free_after. It allocates nothing:
// the caller passes the outputs and a scratch buffer of 2 * max_blocks
// slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = kThreads - 32;  // all warps but the exchange warp
constexpr int kMaxR = 32;
constexpr int kStages = 8;
constexpr int kPollPerLane = 8;
constexpr int kMaxBlocks = 32 * kPollPerLane;  // block index fits 8 bits
constexpr float kNeg = -3.0e38f;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;

// Named barriers (0 is __syncthreads). kBarLook: the scan warps arrive
// with the look-ahead partials, the exchange warp waits. kBarDebit: the
// exchange warp arrives after the debit, the scan warps wait. kBarRescan:
// the scan warps arrive with a rescan's partials, the exchange warp waits.
constexpr int kBarLook = 1;
constexpr int kBarDebit = 2;
constexpr int kBarRescan = 3;

// A candidate: score key, noise key (x >> 8, 24 bits), column. Larger keys
// win, then the smaller column. Every real column has skey > 0.
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

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Pod i's tag, 1..255: never the zeroed slot's 0, and never pod i-2's.
__device__ __forceinline__ uint32_t tag_of(int i) {
  return static_cast<uint32_t>(i % 255) + 1u;
}

// Exchange warp: wait until every block's slot carries `tag`; return the
// winner as skey << 32 | nkey << 8 | (255 - block), whose maximum is the
// best score, then noise, then the lowest block (slices are contiguous,
// so the lowest block holds the smaller column). Each lane keeps the
// loads of all its slots in flight together.
__device__ uint64_t poll(const uint64_t* buf, int nblocks, uint32_t tag) {
  const int lane = threadIdx.x & 31;
  uint32_t todo = 0;
#pragma unroll
  for (int t = 0; t < kPollPerLane; ++t)
    if (lane + 32 * t < nblocks) todo |= 1u << t;
  uint64_t best = 0;
  while (todo) {
    uint64_t v[kPollPerLane];
#pragma unroll
    for (int t = 0; t < kPollPerLane; ++t)
      if (todo >> t & 1u) v[t] = ld_relaxed(&buf[lane + 32 * t]);
#pragma unroll
    for (int t = 0; t < kPollPerLane; ++t) {
      if ((todo >> t & 1u) && (v[t] & 0xffu) == tag) {
        const uint64_t key = (v[t] & ~0xffull) | (255u - (lane + 32 * t));
        if (key > best) best = key;
        todo &= ~(1u << t);
      }
    }
  }
  const uint32_t hi = __reduce_max_sync(kFull, static_cast<uint32_t>(best >> 32));
  const uint32_t lo = __reduce_max_sync(
      kFull, static_cast<uint32_t>(best >> 32) == hi
                 ? static_cast<uint32_t>(best)
                 : 0u);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// kRing: the scores come through the ring; otherwise (slices too wide for
// the ring) straight from device memory.
template <bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
greedy_assign_kernel(const float* __restrict__ scores,
                     const float* __restrict__ requests,
                     const float* __restrict__ free0, uint32_t seed, int P,
                     int N, int R, int slice, int32_t* __restrict__ chosen,
                     uint8_t* __restrict__ assigned,
                     float* __restrict__ free_after, uint64_t* slots) {
  extern __shared__ float smem[];
  float* free_s = smem;               // [R][slice], this block's columns
  float* ring_s = smem + R * slice;   // [kStages][slice] when kRing
  __shared__ float req_s[kStages][kMaxR];
  __shared__ uint32_t look_s[3 * kWarps];    // look-ahead partials per warp
  __shared__ uint32_t rescan_s[3 * kWarps];  // rescan partials per warp
  __shared__ int rescan_flag;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int st = tid - 32;  // index among the scan threads
  const int nblocks = gridDim.x;
  const int lo = blockIdx.x * slice;
  const int hi = min(lo + slice, N);
  const int width = max(hi - lo, 0);
  const uint32_t neg_key = score_key(kNeg);

  for (int k = tid; k < width * R; k += kThreads) {
    const int j = k / R;
    free_s[(k - j * R) * slice + j] = free0[static_cast<size_t>(lo) * R + k];
  }
  if (tid == 0) rescan_flag = 0;

  // Scan threads only. Each commits one group per call, so the counts
  // agree: pod k's copies are group k.
  auto issue = [&](int pod) {
    if (pod < P) {
      const int s = pod % kStages;
      if (st < R)
        cp_async4(&req_s[s][st], requests + static_cast<size_t>(pod) * R + st);
      if (kRing) {
        const float* src = scores + static_cast<size_t>(pod) * N + lo;
        float* dst = ring_s + s * slice;
        for (int j = st; j < width; j += kScanThreads) cp_async4(dst + j, src + j);
      }
    }
    cp_async_commit();
  };
  auto score_at = [&](int pod, int j) -> float {
    if (kRing) return ring_s[(pod % kStages) * slice + j];
    return __ldg(scores + static_cast<size_t>(pod) * N + lo + j);
  };
  // This scan thread's best for `pod` against free as it stands.
  auto scan = [&](int pod) -> Best {
    const float* rq = req_s[pod % kStages];
    Best best = kEmpty;
    for (int j = st; j < width; j += kScanThreads) {
      bool fits = true;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R) fits &= free_s[r * slice + j] >= rq[r];
      if (!fits) continue;
      const uint32_t sk = score_key(score_at(pod, j));
      if (sk < best.skey) continue;
      const Best t{sk, noise_key(seed, pod, lo + j),
                   static_cast<uint32_t>(lo + j)};
      if (better(t, best)) best = t;
    }
    return warp_best(best);
  };
  auto put = [&](uint32_t* part, const Best& b) {
    if (lane == 0) {
      part[warp] = b.skey;
      part[kWarps + warp] = b.nkey;
      part[2 * kWarps + warp] = b.col;
    }
  };
  auto gather = [&](const uint32_t* part) -> Best {  // exchange warp
    const int w = lane + 1;
    return warp_best(w < kWarps ? Best{part[w], part[kWarps + w],
                                       part[2 * kWarps + w]}
                                : kEmpty);
  };

  // Pods 0..kStages-3 go out first, pod i+kStages-2 in iteration i, into
  // the stage of pod i-2, which every reader has left behind a barrier.
  if (warp != 0) {
    for (int k = 0; k < kStages - 2; ++k) issue(k);
    cp_async_wait<kStages - 4>();  // pods 0 and 1
  }
  __syncthreads();
  if (warp != 0) put(rescan_s, scan(0));
  __syncthreads();

  if (warp == 0) {
    // The exchange warp: publish, poll, debit and fix up.
    Best pend = gather(rescan_s);
    bool rescan = false;
    for (int i = 0; i < P; ++i) {
      if (rescan) {
        bar_sync(kBarRescan);
        pend = gather(rescan_s);
      }
      uint64_t* buf = slots + (i & 1) * nblocks;
      const uint32_t tag = tag_of(i);
      if (lane == 0)
        st_relaxed(&buf[blockIdx.x], static_cast<uint64_t>(pend.skey) << 32 |
                                         static_cast<uint64_t>(pend.nkey) << 8 |
                                         tag);
      const uint64_t key = poll(buf, nblocks, tag);
      bar_sync(kBarLook);
      Best next = gather(look_s);  // pod i+1, free before pod i's debit
      const bool ok = static_cast<uint32_t>(key >> 32) > neg_key;
      rescan = false;
      if (ok && 255 - static_cast<int>(key & 0xffu) == blockIdx.x) {
        // This block owns the winner, pend.col: debit, fix the look-ahead.
        const uint32_t wcol = pend.col;
        const int wj = static_cast<int>(wcol) - lo;
        bool fit_r = true;
        if (lane < R) {
          float* f = &free_s[lane * slice + wj];
          const float v = __fsub_rn(*f, req_s[i % kStages][lane]);
          *f = v;
          fit_r = i + 1 < P && v >= req_s[(i + 1) % kStages][lane];
        }
        const bool wfits = __all_sync(kFull, fit_r);
        if (lane == 0) {
          chosen[i] = static_cast<int32_t>(wcol);
          assigned[i] = 1;
        }
        if (i + 1 < P) {
          if (next.col == wcol && !wfits) {
            rescan = true;
          } else if (wfits) {
            const Best c{score_key(score_at(i + 1, wj)),
                         noise_key(seed, i + 1, wcol), wcol};
            if (better(c, next)) next = c;
          }
        }
      } else if (!ok && blockIdx.x == 0 && lane == 0) {
        chosen[i] = -1;
        assigned[i] = 0;
      }
      if (i + 1 < P) {
        if (lane == 0) rescan_flag = rescan;
        bar_arrive(kBarDebit);
      }
      pend = next;
    }
  } else {
    // The scan warps: the look-ahead for pod i+1 while pod i is exchanged.
    for (int i = 0; i < P; ++i) {
      cp_async_wait<kStages - 4>();  // pods up to i+1
      if (i > 0) bar_sync(kBarDebit);  // pod i-1 debited
      if (rescan_flag) {
        put(rescan_s, scan(i));
        bar_arrive(kBarRescan);
      }
      put(look_s, i + 1 < P ? scan(i + 1) : kEmpty);
      bar_arrive(kBarLook);
      issue(i + kStages - 2);  // after the scan: its loads do not queue behind
    }
  }

  __syncthreads();
  for (int k = tid; k < width * R; k += kThreads) {
    const int j = k / R;
    free_after[static_cast<size_t>(lo) * R + k] = free_s[(k - j * R) * slice + j];
  }
}

}  // namespace

extern "C" int greedy_assign_launch(const float* scores, const float* requests,
                                    const float* free0, uint32_t seed, int P,
                                    int N, int R, int32_t* chosen,
                                    uint8_t* assigned, float* free_after,
                                    void* scratch, int max_blocks,
                                    void* stream) {
  if (N < 1 || P < 0 || R < 1 || R > kMaxR)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 0) {
    const cudaError_t err = cudaMemcpyAsync(
        free_after, free0, sizeof(float) * N * R, cudaMemcpyDeviceToDevice, st);
    return err != cudaSuccess ? err : kNoLaunch;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  // At least 64 columns per block; at most one block per SM.
  int nblocks = (N + 63) / 64;
  if (nblocks > sms) nblocks = sms;
  if (nblocks > max_blocks) nblocks = max_blocks;
  if (nblocks > kMaxBlocks) nblocks = kMaxBlocks;
  int slice = (N + nblocks - 1) / nblocks;

  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, greedy_assign_kernel<true>);
  if (err != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(smem_optin) - attr.sharedSizeBytes;
  const size_t free_bytes = sizeof(float) * static_cast<size_t>(slice) * R;
  const size_t ring_bytes = sizeof(float) * static_cast<size_t>(slice) * kStages;
  const bool ring = free_bytes + ring_bytes <= budget;
  const size_t smem = free_bytes + (ring ? ring_bytes : 0);
  if (smem > budget) return cudaErrorInvalidConfiguration;
  const void* kernel =
      reinterpret_cast<const void*>(ring ? greedy_assign_kernel<true>
                                         : greedy_assign_kernel<false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  uint64_t* slots = static_cast<uint64_t*>(scratch);
  err = cudaMemsetAsync(slots, 0, sizeof(uint64_t) * 2 * nblocks, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&scores, &requests, &free0,    &seed,       &P,
                  &N,      &R,        &slice,    &chosen,     &assigned,
                  &free_after, &slots};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int greedy_assign_slot_bytes() { return sizeof(uint64_t); }

extern "C" const char* greedy_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
