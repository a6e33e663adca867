// The greedy assignment under in-scan hard-spread domain caps, for Hopper.
//
// Replaces the JAX package's caps scan: minisched_tpu/ops/select.py:80-127
// (greedy_assign with caps=..., a lax.scan, not a Pallas kernel) with
// minisched_tpu/ops/spreadcap.py:176 (caps_mask) and :198 (caps_update).
// Same function, bit for bit. Pods are taken in row order; for pod i:
//   1. a node is allowed when, for every enforced constraint slot c of the
//      pod (slot_h[i][c] = h >= 0), its compact domain d = domc[h][node] is
//      missing (d < 0) or (count[h][d] + 1) - min_h <= slot_skew[i][c],
//      min_h being the least count over the group's existing domains
//      (3e38 when none exists), all in float32 as the JAX expression;
//   2. among allowed nodes whose free resources cover the request on every
//      axis, the winner is the largest score, then the largest tie noise
//      tie_noise_from_cols(seed, i, col), then the smallest column; a
//      winner above NEG is assigned and its free row debited (one IEEE
//      subtraction, as free.at[row].add(-req));
//   3. every group h the pod matches (match[i][h]) gains 1.0 in the
//      winner's domain domc[h][winner] when that is >= 0.
//
// Bound. At bench-50k (P=1024, N=53248, R=10) the kernel must read the
// scores once, 218 MB, about 65 us at 3.35 TB/s. As in the greedy kernel
// the work is a chain of 1024 dependent argmaxes, each spanning every SM,
// so the limit is one cross-SM exchange per pod. Unlike the greedy kernel
// it has no look-ahead: a debit changes one node's row, but a count update
// changes the verdict of a whole domain, and a rising min can re-admit
// domains, so pod i+1's scan starts after pod i's count update.
//
// Layout. One cooperative launch, one block per SM (fewer for small N).
// Block b owns a contiguous slice of node columns and keeps in shared
// memory, for the whole batch: the slice's free rows ([R][slice]), its
// compact domains per group ([H][slice], int16), and its own copy of the
// (H,K) count table with the per-group minima (every block learns each
// winner from the exchange, so every copy takes the same updates). The
// pod's scores, request, slots and matches arrive one pod ahead in a
// two-stage shared buffer (cp.async), so no load from device memory sits
// on the chain. Per pod: every thread scans its columns of the slice,
// checking each enforced slot's running skew against the count table,
// and the block reduces to one candidate (one barrier). Warp 0 then
// publishes it and polls every block's slots:
// the one-round tagged exchange of the greedy kernel (score key << 32 |
// noise key << 8 | tag, slots double-buffered by pod parity, tags
// i % 255 + 1), plus two words per block that carry its candidate's
// compact domain in each group, a byte per group, seven groups and the
// tag to a word (so H <= 14, K <= 255). Every word is tagged, so each is
// checked on its own and relaxed loads and stores suffice; the poll
// loads all of them together, and every block learns the winner's
// domains in the same round trip as the winner. Every block then adds
// the pod's matches into its count table and recomputes the minima of
// the groups it touched; the owner of the winning column debits it and
// writes chosen[i] (the second barrier).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): 4.28-4.31 ms at
// config 4 hard's full width (1024 x 53248, H=8, K=128, C=2), about 4.2 us
// per pod, against 5.04-5.06 ms in turns for the version that staged the
// pod's inputs from device memory after each pod and built a (C,K)
// allowed-domain table behind two more barriers, and 5.27 ms for the
// first, whose blocks also read the winner's column from a second slot
// and then its domains from device memory, two more round trips per pod.
//
// Interface: a plain C function that launches on the caller's stream and
// returns the cudaError_t of the launch, or kNoLaunch (-1) for an empty
// batch, where it only copies free0 into free_after. It allocates nothing:
// the caller passes the outputs and a scratch buffer of 6 * max_blocks
// 8-byte slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 32;
constexpr int kMaxC = 8;
constexpr int kGroupsPerWord = 7;  // a domain word: 7 domain bytes + tag
constexpr int kDomWords = 2;
constexpr int kMaxH = kGroupsPerWord * kDomWords;
constexpr int kMaxK = 255;  // a compact domain fits a byte; 0xff is none
constexpr int kPollPerLane = 8;
constexpr int kMaxBlocks = 32 * kPollPerLane;  // block index fits 8 bits
constexpr float kNeg = -3.0e38f;
constexpr float kBigF = 3.0e38f;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;

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

// Order-preserving u32 key of a float score; -0 maps to +0, which float
// compare calls equal.
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// Warp 0: wait until every block's slots for this pod carry `tag` (the
// key word and the candidate's domain words, each tagged, so each is
// checked on its own and relaxed loads suffice); return the winner as
// skey << 32 | nkey << 8 | (255 - block), whose maximum is the best
// score, then noise, then the lowest block (slices are contiguous, so
// the lowest block holds the smaller column), and the winner's domain
// words in dom[]. Each lane keeps the loads of all its slots in flight
// together.
__device__ uint64_t poll(const uint64_t* kbuf, const uint64_t* dbuf,
                         int nblocks, int nwords, uint32_t tag,
                         uint64_t* dom) {
  const int lane = threadIdx.x & 31;
  uint32_t todo = 0;
#pragma unroll
  for (int t = 0; t < kPollPerLane; ++t)
    if (lane + 32 * t < nblocks) todo |= 1u << t;
  uint64_t best = 0;
  uint64_t bdom[kDomWords] = {};
  while (todo) {
    uint64_t v[kPollPerLane];
    uint64_t d[kPollPerLane][kDomWords];
#pragma unroll
    for (int t = 0; t < kPollPerLane; ++t) {
      if (todo >> t & 1u) {
        const int b = lane + 32 * t;
        v[t] = ld_relaxed(&kbuf[b]);
#pragma unroll
        for (int w = 0; w < kDomWords; ++w)
          d[t][w] = w < nwords ? ld_relaxed(&dbuf[b * kDomWords + w]) : tag;
      }
    }
#pragma unroll
    for (int t = 0; t < kPollPerLane; ++t) {
      if (!(todo >> t & 1u) || (v[t] & 0xffu) != tag) continue;
      bool fresh = true;
#pragma unroll
      for (int w = 0; w < kDomWords; ++w) fresh &= (d[t][w] & 0xffu) == tag;
      if (fresh) {
        const uint64_t key = (v[t] & ~0xffull) | (255u - (lane + 32 * t));
        if (key > best) {
          best = key;
#pragma unroll
          for (int w = 0; w < kDomWords; ++w) bdom[w] = d[t][w];
        }
        todo &= ~(1u << t);
      }
    }
  }
  const uint32_t hi =
      __reduce_max_sync(kFull, static_cast<uint32_t>(best >> 32));
  const uint32_t lo = __reduce_max_sync(
      kFull, static_cast<uint32_t>(best >> 32) == hi
                 ? static_cast<uint32_t>(best)
                 : 0u);
  const uint64_t win = static_cast<uint64_t>(hi) << 32 | lo;
  const int src = __ffs(__ballot_sync(kFull, best == win)) - 1;
#pragma unroll
  for (int w = 0; w < kDomWords; ++w) dom[w] = __shfl_sync(kFull, bdom[w], src);
  return win;
}

// The least count over the existing domains of group h (kBigF when none
// exists), by warp 0; fminf is exact, so the order does not matter.
__device__ float group_min(const float* counts_s, const uint8_t* dexist_s,
                           int h, int K) {
  const int lane = threadIdx.x & 31;
  float m = kBigF;
  for (int k = lane; k < K; k += 32)
    if (dexist_s[h * K + k]) m = fminf(m, counts_s[h * K + k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
  return m;
}

__global__ void __launch_bounds__(kThreads, 1)
caps_scan_kernel(const float* __restrict__ scores,
                 const float* __restrict__ requests,
                 const float* __restrict__ free0, uint32_t seed,
                 const int32_t* __restrict__ slot_h,
                 const float* __restrict__ slot_skew,
                 const int32_t* __restrict__ domc,
                 const float* __restrict__ counts0,
                 const uint8_t* __restrict__ dexist,
                 const uint8_t* __restrict__ match, int P, int N, int R,
                 int C, int H, int K, int slice, int32_t* __restrict__ chosen,
                 uint8_t* __restrict__ assigned,
                 float* __restrict__ free_after, uint64_t* key_slots,
                 uint64_t* dom_slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* free_s = reinterpret_cast<float*>(smem_raw);  // [R][slice]
  float* score_s = free_s + R * slice;                 // [2][slice]
  float* counts_s = score_s + 2 * slice;               // [H][K]
  int16_t* domc_s = reinterpret_cast<int16_t*>(counts_s + H * K);  // [H][slice]
  uint8_t* dexist_s =
      reinterpret_cast<uint8_t*>(domc_s + H * slice);  // [H][K]

  // The pod's request, slots and matches, copied one pod ahead with its
  // scores (two stages, by pod parity).
  __shared__ float req_s[2][kMaxR];
  __shared__ float skew_s[2][kMaxC];
  __shared__ int slot_s[2][kMaxC];
  __shared__ uint8_t match_s[2][kMaxH];
  __shared__ float mins_s[kMaxH];
  __shared__ uint32_t part_s[3 * kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nblocks = gridDim.x;
  const int lo = blockIdx.x * slice;
  const int hi = min(lo + slice, N);
  const int width = max(hi - lo, 0);
  const uint32_t neg_key = score_key(kNeg);
  const int nwords = (H + kGroupsPerWord - 1) / kGroupsPerWord;

  for (int k = tid; k < width * R; k += kThreads) {
    const int j = k / R;
    free_s[(k - j * R) * slice + j] = free0[static_cast<size_t>(lo) * R + k];
  }
  for (int k = tid; k < H * width; k += kThreads) {
    const int h = k / width, j = k - h * width;
    domc_s[h * slice + j] =
        static_cast<int16_t>(domc[static_cast<size_t>(h) * N + lo + j]);
  }
  for (int k = tid; k < H * K; k += kThreads) {
    counts_s[k] = counts0[k];
    dexist_s[k] = dexist[k];
  }
  // Every thread; one commit group per call, so "wait for all groups"
  // at the end of pod i means pod i+1's inputs have landed.
  auto issue = [&](int pod) {
    if (pod < P) {
      const int st = pod & 1;
      const float* src = scores + static_cast<size_t>(pod) * N + lo;
      float* dst = score_s + st * slice;
      for (int j = tid; j < width; j += kThreads) cp_async4(dst + j, src + j);
      if (tid < R)
        cp_async4(&req_s[st][tid], requests + static_cast<size_t>(pod) * R + tid);
      if (tid >= 32 && tid - 32 < C) {
        const size_t e = static_cast<size_t>(pod) * C + tid - 32;
        cp_async4(&slot_s[st][tid - 32], slot_h + e);
        cp_async4(&skew_s[st][tid - 32], slot_skew + e);
      }
    }
    cp_async_commit();
  };
  // The match bytes have no 4-byte alignment for cp.async: a plain load,
  // issued a pod ahead and stored before the pod's last barrier.
  const bool loads_match = tid >= 64 && tid - 64 < H;
  auto load_match = [&](int pod) -> uint8_t {
    return loads_match && pod < P
               ? match[static_cast<size_t>(pod) * H + tid - 64] : 0;
  };
  issue(0);
  if (loads_match) match_s[0][tid - 64] = load_match(0);
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    for (int h = 0; h < H; ++h) {
      const float m = group_min(counts_s, dexist_s, h, K);
      if (lane == 0) mins_s[h] = m;
    }
  }
  __syncthreads();

  for (int i = 0; i < P; ++i) {
    // Pod i's inputs landed and its counts are final (the barrier at the
    // end of pod i-1); pod i+1's copies go out into the stage pod i-1
    // used, which every reader has left behind that barrier.
    issue(i + 1);
    const uint8_t next_match = load_match(i + 1);
    const int st = i & 1;
    const float* rq = req_s[st];
    const int* slots = slot_s[st];
    const float* skews = skew_s[st];

    Best best = kEmpty;
    const float* srow = score_s + st * slice;
    for (int j = tid; j < width; j += kThreads) {
      bool fits = true;
#pragma unroll 4
      for (int r = 0; r < R; ++r) fits &= free_s[r * slice + j] >= rq[r];
      // The running skew check, (count + 1) - min <= max_skew in float32
      // as the JAX expression, for each enforced slot.
      for (int c = 0; c < C; ++c) {
        const int h = slots[c];
        if (h >= 0) {
          const int d = domc_s[h * slice + j];
          if (d >= 0 &&
              !(__fsub_rn(__fadd_rn(counts_s[h * K + d], 1.0f), mins_s[h]) <=
                skews[c]))
            fits = false;
        }
      }
      if (!fits) continue;
      const uint32_t sk = score_key(srow[j]);
      if (sk < best.skey) continue;
      const Best t{sk, noise_key(seed, i, lo + j),
                   static_cast<uint32_t>(lo + j)};
      if (better(t, best)) best = t;
    }
    best = warp_best(best);
    if (lane == 0) {
      part_s[warp] = best.skey;
      part_s[kWarps + warp] = best.nkey;
      part_s[2 * kWarps + warp] = best.col;
    }
    __syncthreads();  // (C)

    if (warp == 0) {
      const Best pend = warp_best(
          lane < kWarps ? Best{part_s[lane], part_s[kWarps + lane],
                               part_s[2 * kWarps + lane]}
                        : kEmpty);
      const uint32_t tag = tag_of(i);
      uint64_t* kbuf = key_slots + (i & 1) * nblocks;
      uint64_t* dbuf = dom_slots + (i & 1) * nblocks * kDomWords;
      // The candidate's compact domain per group, one byte each (0xff:
      // none), seven to a tagged word: the blocks that do not own the
      // winner learn its domains from the exchange itself.
      const int pj = static_cast<int>(pend.col) - lo;
      uint32_t db = 0xffu;
      if (lane < H && pj >= 0 && pj < width) {
        const int d = domc_s[lane * slice + pj];
        if (d >= 0) db = static_cast<uint32_t>(d);
      }
      const int shift = 8 * (1 + lane % kGroupsPerWord);
#pragma unroll
      for (int w = 0; w < kDomWords; ++w) {
        const bool mine = lane < H && lane / kGroupsPerWord == w;
        const uint64_t part = mine ? static_cast<uint64_t>(db) << shift : 0;
        const uint32_t wlo = __reduce_or_sync(kFull, static_cast<uint32_t>(part));
        const uint32_t whi =
            __reduce_or_sync(kFull, static_cast<uint32_t>(part >> 32));
        if (lane == 0 && w < nwords)
          st_relaxed(&dbuf[blockIdx.x * kDomWords + w],
                     (static_cast<uint64_t>(whi) << 32 | wlo) | tag);
      }
      if (lane == 0)
        st_relaxed(&kbuf[blockIdx.x],
                   static_cast<uint64_t>(pend.skey) << 32 |
                       static_cast<uint64_t>(pend.nkey) << 8 | tag);
      uint64_t dom[kDomWords];
      const uint64_t key = poll(kbuf, dbuf, nblocks, nwords, tag, dom);
      const bool ok = static_cast<uint32_t>(key >> 32) > neg_key;
      if (ok) {
        if (255 - static_cast<int>(key & 0xffu) == static_cast<int>(blockIdx.x)) {
          // This block owns the winner, pend.col: debit it.
          const int wj = static_cast<int>(pend.col) - lo;
          if (lane < R) {
            float* f = &free_s[lane * slice + wj];
            *f = __fsub_rn(*f, rq[lane]);
          }
          if (lane == 0) {
            chosen[i] = static_cast<int32_t>(pend.col);
            assigned[i] = 1;
          }
        }
        int d = -1;
        if (lane < H && match_s[st][lane]) {
          const uint32_t b = static_cast<uint32_t>(
              dom[lane / kGroupsPerWord] >> (8 * (1 + lane % kGroupsPerWord)))
              & 0xffu;
          if (b != 0xffu) d = static_cast<int>(b);
        }
        if (d >= 0) counts_s[lane * K + d] += 1.0f;
        uint32_t touched = __ballot_sync(kFull, d >= 0);
        __syncwarp();
        while (touched) {
          const int h = __ffs(touched) - 1;
          touched &= touched - 1;
          const float m = group_min(counts_s, dexist_s, h, K);
          if (lane == 0) mins_s[h] = m;
        }
      } else if (blockIdx.x == 0 && lane == 0) {
        chosen[i] = -1;
        assigned[i] = 0;
      }
    }
    cp_async_wait_all();  // this thread's copies of pod i+1
    if (loads_match) match_s[st ^ 1][tid - 64] = next_match;
    __syncthreads();  // (D) counts, minima and free updated
  }

  for (int k = tid; k < width * R; k += kThreads) {
    const int j = k / R;
    free_after[static_cast<size_t>(lo) * R + k] = free_s[(k - j * R) * slice + j];
  }
}

}  // namespace

extern "C" int caps_scan_launch(const float* scores, const float* requests,
                                const float* free0, uint32_t seed,
                                const int32_t* slot_h, const float* slot_skew,
                                const int32_t* domc, const float* counts0,
                                const uint8_t* dexist, const uint8_t* match,
                                int P, int N, int R, int C, int H, int K,
                                int32_t* chosen, uint8_t* assigned,
                                float* free_after, void* scratch,
                                int max_blocks, void* stream) {
  if (N < 1 || P < 0 || R < 1 || R > kMaxR || C < 0 || C > kMaxC ||
      H < 1 || H > kMaxH || K < 1 || K > kMaxK)
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
  // Keep the int16 domain rows 4-byte aligned after the float arrays.
  slice = (slice + 1) & ~1;

  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, caps_scan_kernel);
  if (err != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(smem_optin) - attr.sharedSizeBytes;
  const size_t smem = sizeof(float) * static_cast<size_t>(slice) * (R + 2) +
                      sizeof(float) * static_cast<size_t>(H) * K +
                      sizeof(int16_t) * static_cast<size_t>(H) * slice +
                      static_cast<size_t>(H) * K;
  if (smem > budget) return cudaErrorInvalidConfiguration;
  const void* kernel = reinterpret_cast<const void*>(caps_scan_kernel);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;

  uint64_t* key_slots = static_cast<uint64_t*>(scratch);
  uint64_t* dom_slots = key_slots + 2 * nblocks;
  err = cudaMemsetAsync(key_slots, 0,
                        sizeof(uint64_t) * 2 * nblocks * (1 + kDomWords), st);
  if (err != cudaSuccess) return err;
  void* args[] = {&scores, &requests, &free0,  &seed,      &slot_h,
                  &slot_skew, &domc,   &counts0, &dexist,  &match,
                  &P,      &N,        &R,      &C,         &H,
                  &K,      &slice,    &chosen, &assigned,  &free_after,
                  &key_slots, &dom_slots};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(kThreads),
                                    args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int caps_scan_slot_bytes() { return sizeof(uint64_t); }

extern "C" const char* caps_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
