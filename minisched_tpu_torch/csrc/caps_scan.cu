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
// Bound. At config 4 hard's full width (P=1024, N=53248, R=10) the kernel
// must read the scores once, 218 MB, about 65 us at 3.35 TB/s. As in the
// greedy kernel the work is a chain of 1024 dependent argmaxes, each
// spanning every SM, so the limit is one cross-SM exchange per pod.
//
// Layout. One cooperative launch, one block per SM (fewer for small N).
// Block b owns a contiguous slice of node columns and keeps in shared
// memory, for the whole batch: the slice's free rows ([R][slice]), its
// compact domains per group ([H][slice], int16) and, per column, the
// domain words the exchange sends (below), and its own copy of the
// (H,K) count table with, per group, the least count over the existing
// domains and how many existing domains hold it (every block learns each
// winner from the exchange, so every copy takes the same updates). A ring
// of kStages stages holds the next pods' score slices, requests, slots and
// match bits, copied six pods ahead (cp.async), so no load from device
// memory sits on the chain. Warp 0 is the exchange warp; the other 15 warps
// scan.
//
// The exchange (the greedy kernel's): each block's exchange warp publishes
// its candidate for pod i as one tagged 8-byte word (score key << 32 |
// noise key << 8 | tag) plus two tagged words carrying the candidate's
// compact domain in each group, a byte per group, seven to a word (so H <=
// 14, K <= 255), and polls every block's words; every block learns the
// winner and its domains in one round trip.
//
// The look-ahead across the count update. While pod i is exchanged, the
// scan warps reduce pod i+1 against the counts, minima and free rows as
// they stand before pod i's update, to two candidates: p1, the best allowed
// fitting node, and p2, the best allowed fitting node whose domain in
// pod i+1's pivot group g (the group of its first enforced slot; a missing
// domain counts as a domain of its own) differs from p1's. After the poll
// the exchange warp reads pod i's update (the debit by the owner, the
// count of domain dw_h + 1 in each group h it matches, the minima kept
// incrementally: a minimum moves only when its last holder rises, and only
// then is the group's minimum recomputed over K), takes pod i+1's
// candidate without a scan and publishes it; only then does it write the
// update into shared memory, off the chain (the scan warps wait for it
// before their next look-ahead). The candidate:
//   - a group pod i+1 enforces other than g was touched, or g's minimum
//     rose (domains may re-open): rescan;
//   - else only dw_g's verdict can have changed, and only to closed: if it
//     closed and p1 lies in dw_g, the best allowed node is p2 (the best
//     outside p1's domain); otherwise p1 stands;
//   - the debit changes one node w's row, in the owner block only (the
//     greedy kernel's cases): if the candidate is w and w no longer fits,
//     rescan; if w fits, it joins as better(candidate, w) when its full
//     verdict under the new counts allows it (nothing assumes the sign of
//     a request: a negative request raises free);
//   - a pod with no enforced slot is the greedy kernel's case alone.
// p2 is never w when it is needed: it is needed only when p1's domain,
// dw_g = w's domain in g, closed, and p2 lies outside it. A rescan is the
// exact reduction of the slice from shared memory by the scan warps, on
// the chain (the greedy kernel's rescan). The counts0 the step builds are
// integer-valued (spreadcap.build_domain_caps sums 1.0 per pod), but
// nothing here assumes it: the minimum's holders are counted with float
// equality, a count that does not move (1.0 lost in rounding) moves
// nothing, and a moved minimum is recomputed.
//
// Within a block, named barriers replace __syncthreads on the chain: the
// scan warps arrive with their look-ahead partials, which the exchange
// warp waits for only after its poll; the exchange warp arrives after the
// update, which the scan warps wait for before the next scan.
//
// Two more things keep the chain short: each column's domain words are
// built once, so a publish is two shared-memory loads and three stores by
// one lane; and each block debits its own candidate before the poll (only
// the exchange warp writes free_s), so the winner's owner, the slowest
// block of every pod, has its debit and w's fit ready when the poll ends.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/caps_kernel_timing.py,
// PERF.md): about 2.5 ms at config 4 hard's full width (2.45 us a pod)
// against 4.1 ms for the kernel without the look-ahead, in turns; 1.05
// against 1.84 ms at 512 x 4096. Of a pod's chain the poll is about 1.5
// us; reading the update, deciding the candidate and publishing it about
// 0.7 us; 63 of 1024 pods rescan (the minimum rises every 16th pod), and
// p2 stands in on 144.
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
constexpr int kScanThreads = kThreads - 32;  // all warps but the exchange
constexpr int kStages = 8;
constexpr int kMaxR = 32;
constexpr int kMaxC = 8;
constexpr int kGroupsPerWord = 7;  // a domain word: 7 domain bytes + tag
constexpr int kDomWords = 2;
constexpr int kMaxH = kGroupsPerWord * kDomWords;
constexpr int kMaxK = 255;  // a compact domain fits a byte; 0xff is none
constexpr int kPollPerLane = 5;  // 160 blocks: an H100 has 132 SMs
constexpr int kMaxBlocks = 32 * kPollPerLane;  // block index fits 8 bits
constexpr float kNeg = -3.0e38f;
constexpr float kBigF = 3.0e38f;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kMaxCol = 0xffffffu;   // a candidate's column bits
constexpr uint32_t kMissing = 0xffu;      // its pivot domain when d < 0

// Named barriers (0 is __syncthreads), as in the greedy kernel.
constexpr int kBarLook = 1;
constexpr int kBarDebit = 2;
constexpr int kBarRescan = 3;

// A candidate: score key, noise key (x >> 8, 24 bits), and column << 8 |
// its pivot domain (so the smallest cd is the smallest column). Larger
// keys win, then the smaller column. Every real column has skey > 0; the
// empty candidate's pivot domain reads as kMissing, which only ever meets
// another empty candidate.
struct Best {
  uint32_t skey;
  uint32_t nkey;
  uint32_t cd;
};

constexpr Best kEmpty{0u, 0u, 0xffffffffu};

// p1 and the best candidate outside p1's pivot domain.
struct Pair {
  Best b1, b2;
};

__device__ __forceinline__ uint32_t col_of(const Best& b) {
  return b.cd >> 8;
}

__device__ __forceinline__ uint32_t dom_of(const Best& b) {
  return b.cd & 0xffu;
}

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
  return a.cd < b.cd;
}

// c ? x : y, field by field (selects in registers, no address taken).
__device__ __forceinline__ Best sel(bool c, const Best& x, const Best& y) {
  return Best{c ? x.skey : y.skey, c ? x.nkey : y.nkey, c ? x.cd : y.cd};
}

// A thread's pair after one more candidate t: t beats p1, which then
// stays the best outside t's domain unless it shares it (then p2 does),
// or t competes for p2 when it lies outside p1's domain.
__device__ __forceinline__ Pair add(const Pair& p, const Best& t) {
  const bool win = better(t, p.b1);
  const Best out = sel(win ? dom_of(p.b1) != dom_of(t)
                           : dom_of(t) != dom_of(p.b1) && better(t, p.b2),
                       win ? p.b1 : t, p.b2);
  return Pair{sel(win, t, p.b1), out};
}

__device__ __forceinline__ Best warp_best(const Best& t) {
  const uint32_t s = __reduce_max_sync(kFull, t.skey);
  const uint32_t n = __reduce_max_sync(kFull, t.skey == s ? t.nkey : 0u);
  const uint32_t c = __reduce_min_sync(
      kFull, t.skey == s && t.nkey == n ? t.cd : 0xffffffffu);
  return Best{s, n, c};
}

// The warp's pair from each lane's pair: p1 is the best of the lanes'
// p1; each lane's best outside p1's domain is its p1 when that lies
// outside, else its p2 (its best outside its p1's domain, which is p1's).
__device__ __forceinline__ Pair warp_pair(const Pair& p) {
  const Best b1 = warp_best(p.b1);
  return Pair{b1, warp_best(sel(dom_of(p.b1) != dom_of(b1), p.b1, p.b2))};
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

// By one warp: the least count over the existing domains of group h
// (kBigF when none exists; fminf is exact, so the order does not matter)
// into mins_s[h], and how many existing domains hold it into atmin_s[h].
__device__ void group_min(const float* counts_s, const uint8_t* dexist_s,
                          float* mins_s, int* atmin_s, int h, int K) {
  const int lane = threadIdx.x & 31;
  float m = kBigF;
  for (int k = lane; k < K; k += 32)
    if (dexist_s[h * K + k]) m = fminf(m, counts_s[h * K + k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
  int n = 0;
  for (int k = lane; k < K; k += 32)
    n += dexist_s[h * K + k] && counts_s[h * K + k] == m;
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) {
    mins_s[h] = m;
    atmin_s[h] = n;
  }
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
  // Each column's domain words as the exchange sends them (tag 0).
  uint64_t* dword_s = reinterpret_cast<uint64_t*>(smem_raw);  // [slice][2]
  float* free_s = reinterpret_cast<float*>(dword_s + slice * kDomWords);
  // free_s: [R][slice]
  float* ring_s = free_s + R * slice;                  // [kStages][slice]
  float* counts_s = ring_s + kStages * slice;          // [H][K]
  int16_t* domc_s = reinterpret_cast<int16_t*>(counts_s + H * K);  // [H][slice]
  uint8_t* dexist_s =
      reinterpret_cast<uint8_t*>(domc_s + H * slice);  // [H][K]

  // The next pods' request, slots and match bits, by ring stage.
  __shared__ float req_s[kStages][kMaxR];
  __shared__ float skew_s[kStages][kMaxC];
  __shared__ int slot_s[kStages][kMaxC];
  __shared__ uint32_t match_s[kStages];
  __shared__ float mins_s[kMaxH];
  __shared__ int atmin_s[kMaxH];
  __shared__ uint32_t look_s[6 * kWarps];    // look-ahead pairs per warp
  __shared__ uint32_t rescan_s[6 * kWarps];  // rescan pairs per warp
  __shared__ int rescan_flag;
  __shared__ uint64_t none_s[kDomWords];  // the words of no candidate

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int st = tid - 32;  // index among the scan threads
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
  if (tid == 0) rescan_flag = 0;

  // Scan threads only. Each commits one group per call, so the counts
  // agree: pod k's copies are group k. The match bytes have no 4-byte
  // alignment for cp.async: one thread loads them and stores the bits.
  auto issue = [&](int pod) {
    if (pod < P) {
      const int s = pod % kStages;
      const float* src = scores + static_cast<size_t>(pod) * N + lo;
      float* dst = ring_s + s * slice;
      for (int j = st; j < width; j += kScanThreads) cp_async4(dst + j, src + j);
      if (st < R)
        cp_async4(&req_s[s][st], requests + static_cast<size_t>(pod) * R + st);
      if (st >= 32 && st - 32 < C) {
        const size_t e = static_cast<size_t>(pod) * C + st - 32;
        cp_async4(&slot_s[s][st - 32], slot_h + e);
        cp_async4(&skew_s[s][st - 32], slot_skew + e);
      }
      if (st == 64) {
        uint8_t m[kMaxH];
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          m[h] = h < H ? match[static_cast<size_t>(pod) * H + h] : 0;
        uint32_t bits = 0;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) bits |= (m[h] ? 1u : 0u) << h;
        match_s[s] = bits;
      }
    }
    cp_async_commit();
  };
  // Whether pod `pod` allows slice column j under the counts as they
  // stand: every enforced slot's running skew check, (count + 1) - min <=
  // max_skew in float32 as the JAX expression.
  auto allowed = [&](int pod, int j) -> bool {
    const int s = pod % kStages;
    bool ok = true;
    for (int c = 0; c < C; ++c) {
      const int h = slot_s[s][c];
      if (h >= 0) {
        const int d = domc_s[h * slice + j];
        if (d >= 0 &&
            !(__fsub_rn(__fadd_rn(counts_s[h * K + d], 1.0f), mins_s[h]) <=
              skew_s[s][c]))
          ok = false;
      }
    }
    return ok;
  };
  auto pivot = [&](int pod) -> int {  // the first enforced slot's group
    const int s = pod % kStages;
    for (int c = 0; c < C; ++c)
      if (slot_s[s][c] >= 0) return slot_s[s][c];
    return -1;
  };
  // This scan thread's pair for `pod` against the state as it stands.
  auto scan = [&](int pod) -> Pair {
    const int s = pod % kStages;
    const float* rq = req_s[s];
    const int g = pivot(pod);
    Pair best{kEmpty, kEmpty};
    for (int j = st; j < width; j += kScanThreads) {
      bool fits = true;
#pragma unroll 4
      for (int r = 0; r < R; ++r) fits &= free_s[r * slice + j] >= rq[r];
      if (!fits || !allowed(pod, j)) continue;
      const int d = g >= 0 ? domc_s[g * slice + j] : -1;
      const uint32_t dom = d >= 0 ? static_cast<uint32_t>(d) : kMissing;
      const Best t{score_key(ring_s[s * slice + j]), noise_key(seed, pod, lo + j),
                   static_cast<uint32_t>(lo + j) << 8 | dom};
      best = add(best, t);
    }
    return warp_pair(best);
  };
  auto put = [&](uint32_t* part, const Pair& p) {
    if (lane == 0) {
      part[6 * warp] = p.b1.skey;
      part[6 * warp + 1] = p.b1.nkey;
      part[6 * warp + 2] = p.b1.cd;
      part[6 * warp + 3] = p.b2.skey;
      part[6 * warp + 4] = p.b2.nkey;
      part[6 * warp + 5] = p.b2.cd;
    }
  };
  auto gather = [&](const uint32_t* part) -> Pair {  // exchange warp
    const int w = lane + 1;
    Pair p{kEmpty, kEmpty};
    if (w < kWarps)
      p = Pair{Best{part[6 * w], part[6 * w + 1], part[6 * w + 2]},
               Best{part[6 * w + 3], part[6 * w + 4], part[6 * w + 5]}};
    return warp_pair(p);
  };

  // Pods 0..kStages-3 go out first, pod i+kStages-2 in iteration i, into
  // the stage of pod i-2, which every reader has left behind a barrier.
  if (warp != 0) {
    for (int k = 0; k < kStages - 2; ++k) issue(k);
    cp_async_wait<kStages - 5>();  // pods 0, 1 and 2
  }
  __syncthreads();
  // A column's compact domain per group, one byte each (0xff: none), seven
  // to a word above the tag byte: the blocks that do not own the winner
  // learn its domains from the exchange itself.
  for (int j = tid; j <= width; j += kThreads) {
    uint64_t w0 = 0, w1 = 0;
    for (int h = 0; h < H; ++h) {
      const int d = j < width ? domc_s[h * slice + j] : -1;
      const uint64_t b = static_cast<uint64_t>(d >= 0 ? d : 0xff)
                         << (8 * (1 + h % kGroupsPerWord));
      if (h < kGroupsPerWord) w0 |= b; else w1 |= b;
    }
    if (j < width) {
      dword_s[j * kDomWords] = w0;
      dword_s[j * kDomWords + 1] = w1;
    } else {
      none_s[0] = w0;
      none_s[1] = w1;
    }
  }
  if (warp == 0) {
    for (int h = 0; h < H; ++h)
      group_min(counts_s, dexist_s, mins_s, atmin_s, h, K);
  }
  __syncthreads();
  if (warp != 0) put(rescan_s, scan(0));
  __syncthreads();

  if (warp == 0) {
    // The exchange warp: poll, decide the next pod's candidate, publish
    // it, then apply the update.
    // Publish `cand` as this block's candidate for `pod`: its domain
    // words, then the key word, each tagged (lane 0).
    auto publish = [&](int pod, const Best& cand) {
      if (lane == 0) {
        const uint32_t tag = tag_of(pod);
        uint64_t* kbuf = key_slots + (pod & 1) * nblocks;
        uint64_t* dbuf = dom_slots + (pod & 1) * nblocks * kDomWords;
        const int pj = static_cast<int>(col_of(cand)) - lo;
        const bool here = cand.skey != 0u && pj >= 0 && pj < width;
        for (int w = 0; w < nwords; ++w)
          st_relaxed(&dbuf[blockIdx.x * kDomWords + w],
                     (here ? dword_s[pj * kDomWords + w] : none_s[w]) | tag);
        st_relaxed(&kbuf[blockIdx.x],
                   static_cast<uint64_t>(cand.skey) << 32 |
                       static_cast<uint64_t>(cand.nkey) << 8 | tag);
      }
    };
    Best pend = gather(rescan_s).b1;
    bool rescan = false, published = false;
    for (int i = 0; i < P; ++i) {
      if (rescan) {
        bar_sync(kBarRescan);
        pend = gather(rescan_s).b1;
      }
      if (!published) publish(i, pend);
      const int si = i % kStages, sn = (i + 1) % kStages;
      // Pod i+1's slots, lane c: group (-1 if not enforced) and skew; its
      // enforced groups and pivot g (its stage landed before the barrier
      // of pod i-1's look-ahead).
      const int hc = i + 1 < P && lane < C ? slot_s[sn][lane] : -1;
      const float skc = lane < C ? skew_s[sn][lane] : 0.0f;
      const uint32_t enforced =
          __reduce_or_sync(kFull, hc >= 0 ? 1u << hc : 0u);
      const uint32_t any = __ballot_sync(kFull, hc >= 0);
      const int g = any ? __shfl_sync(kFull, hc, __ffs(any) - 1) : -1;
      // This block's own candidate, w, debited in advance (only this warp
      // writes free_s): if the block owns pod i's winner, the debit and
      // whether w still fits pod i+1 are ready when the poll returns.
      const uint32_t wcol = col_of(pend);
      const int wj = static_cast<int>(wcol) - lo;
      float wv = 0.0f;
      bool fit_r = true;
      if (pend.skey != 0u && wj >= 0 && wj < width && lane < R) {
        wv = __fsub_rn(free_s[lane * slice + wj], req_s[si][lane]);
        fit_r = i + 1 < P && wv >= req_s[sn][lane];
      }
      const bool wfits_mine = __all_sync(kFull, fit_r);
      const bool matches = lane < H && (match_s[si] >> lane & 1u);
      uint64_t dom[kDomWords];
      const uint64_t key = poll(key_slots + (i & 1) * nblocks,
                                dom_slots + (i & 1) * nblocks * kDomWords,
                                nblocks, nwords, tag_of(i), dom);
      bar_sync(kBarLook);
      const Pair next = gather(look_s);  // pod i+1, before pod i's update
      const bool ok = static_cast<uint32_t>(key >> 32) > neg_key;
      const bool owner =
          ok && 255 - static_cast<int>(key & 0xffu) == static_cast<int>(blockIdx.x);
      // Pod i's update as lane h sees it: the winner's domain in group h
      // when the pod matches h, its count before and after, and whether
      // that raises the group's minimum (its last holder rises).
      bool wfits = false;
      int dwh = -1;
      float old = 0.0f, now = 0.0f;
      bool holder = false;
      if (ok) {
        if (owner) {  // the debit
          if (lane < R) free_s[lane * slice + wj] = wv;
          wfits = wfits_mine;
          if (lane == 0) {
            chosen[i] = static_cast<int32_t>(wcol);
            assigned[i] = 1;
          }
        }
        if (matches) {
          const uint32_t b = static_cast<uint32_t>(
              (lane < kGroupsPerWord ? dom[0] : dom[1]) >>
              (8 * (1 + lane % kGroupsPerWord)))
              & 0xffu;
          if (b != 0xffu) dwh = static_cast<int>(b);
        }
        if (dwh >= 0) {
          old = counts_s[lane * K + dwh];
          now = __fadd_rn(old, 1.0f);
          holder = now != old && dexist_s[lane * K + dwh] && old == mins_s[lane];
        }
      } else if (blockIdx.x == 0 && lane == 0) {
        chosen[i] = -1;
        assigned[i] = 0;
      }
      const uint32_t touched = __ballot_sync(kFull, dwh >= 0);
      const uint32_t risen = __ballot_sync(kFull, holder && atmin_s[lane] == 1);
      // Pod i+1's candidate from the look-ahead.
      rescan = false;
      Best cand = next.b1;
      if (g >= 0 && touched) {
        if ((touched & enforced & ~(1u << g)) || (risen >> g & 1u)) {
          rescan = true;
        } else if (touched >> g & 1u) {
          // dw_g's verdict under the new counts, every slot naming g.
          const uint32_t dw = static_cast<uint32_t>(__shfl_sync(kFull, dwh, g));
          const float lhs = __fsub_rn(__fadd_rn(__shfl_sync(kFull, now, g), 1.0f),
                                      mins_s[g]);
          const bool closed = __any_sync(kFull, hc == g && !(lhs <= skc));
          if (closed && dom_of(next.b1) == dw) cand = next.b2;
        }
      }
      if (!rescan && owner && i + 1 < P) {
        if (col_of(cand) == wcol && !wfits) {
          rescan = true;
        } else if (wfits) {
          // w's full verdict for pod i+1 under the new counts (no
          // minimum it enforces moved, or it rescans above).
          const int dwc = __shfl_sync(kFull, dwh, hc >= 0 ? hc : 0);
          bool ok_c = true;
          if (hc >= 0) {
            const int d = domc_s[hc * slice + wj];
            if (d >= 0) {
              float cnt = counts_s[hc * K + d];
              if (d == dwc) cnt = __fadd_rn(cnt, 1.0f);
              ok_c = __fsub_rn(__fadd_rn(cnt, 1.0f), mins_s[hc]) <= skc;
            }
          }
          if (__all_sync(kFull, ok_c)) {
            const int dg = g >= 0 ? domc_s[g * slice + wj] : -1;
            const Best t{score_key(ring_s[sn * slice + wj]),
                         noise_key(seed, i + 1, wcol),
                         wcol << 8 |
                             (dg >= 0 ? static_cast<uint32_t>(dg) : kMissing)};
            cand = sel(better(t, cand), t, cand);
          }
        }
      }
      if (i + 1 < P) {
        // Publish pod i+1 first: the update below is off the chain, and
        // the scan warps wait for it only before their next look-ahead.
        published = !rescan;
        if (published) publish(i + 1, cand);
        if (dwh >= 0) {
          counts_s[lane * K + dwh] = now;
          if (holder) --atmin_s[lane];
        }
        __syncwarp();
        for (uint32_t m = risen; m; m &= m - 1)
          group_min(counts_s, dexist_s, mins_s, atmin_s, __ffs(m) - 1, K);
        if (lane == 0) rescan_flag = rescan;
        bar_arrive(kBarDebit);
      }
      pend = cand;
    }
  } else {
    // The scan warps: the look-ahead for pod i+1 while pod i is exchanged.
    for (int i = 0; i < P; ++i) {
      cp_async_wait<kStages - 5>();  // pods up to i+2
      if (i > 0) bar_sync(kBarDebit);  // pod i-1's update applied
      if (rescan_flag) {
        put(rescan_s, scan(i));
        bar_arrive(kBarRescan);
      }
      put(look_s, i + 1 < P ? scan(i + 1) : Pair{kEmpty, kEmpty});
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
      H < 1 || H > kMaxH || K < 1 || K > kMaxK || N > static_cast<int>(kMaxCol))
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
  const size_t smem = sizeof(uint64_t) * static_cast<size_t>(slice) *
                          kDomWords +
                      sizeof(float) * static_cast<size_t>(slice) *
                          (R + kStages) +
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
