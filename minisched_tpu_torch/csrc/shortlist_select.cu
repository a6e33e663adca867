// The shortlist selection of one scheduling batch, for Hopper.
//
// Replaces minisched_tpu/ops/select.py shortlist_select (select.py:144-185:
// the noise lattice and two lax.top_k passes, outside any Pallas kernel).
// Same function, bit for bit: per pod row i of scores (P,N),
//   kth       the K-th largest score in lax.top_k's total order (+0.0 above
//             -0.0);
//   cand      K columns in lax.top_k's order of the composite key (2.0 for
//             score > kth, the tie noise for score == kth, -1 below):
//             the nodes above kth in ascending column order, then the
//             boundary nodes by (noise descending, column ascending);
//   kth_noise the K-th composite key, always a boundary node's noise;
//   cand_scores the candidates' scores, for the scan kernel.
// The noise is computed inline from (seed, row, column) in native u32; no
// (P,N) lattice exists.
//
// Lanes. One launch may serve T independent batches of the same P, N and K
// (the fused tenant step, minisched_tpu/ops/pipeline.py build_tenant_step's
// jax.vmap of the two lax.top_k passes): scores is (T*P, N), each lane's
// rows contiguous, and the outputs are (T*P, ...). Row r belongs to lane
// r / P, whose seed is seeds[r / P] (a (T,) u32 array in device memory),
// and its noise row is r mod P, the pod's row within its lane. With no
// seeds array (the per-batch launch, T = 1) the scalar seed serves.
//
// Bound. The function must read the scores once (P*N*4: 218 MB at 1024 x
// 53248, 0.065 ms at 3.35 TB/s) and write the outputs once. The design
// reads each row from device memory once and touches it twice more in
// shared memory, with no histogram:
//
//   pass 1  while the row lands in shared memory (cp.async.bulk, eight
//           chunks, one mbarrier each), every thread keeps the largest
//           order key of its nodes and how many of them hold it;
//   L       the K-th largest of the 1024 thread maxima, by a bisection of
//           __syncthreads_count below the bits that all maxima share
//           (none on a plateau). At least K nodes are >= L, so L <= the
//           K-th key; the nodes above L are few (about K on diverse rows,
//           none on a plateau);
//   pass 2  compacts into a shared-memory list every node with key > L
//           and every node with key == L whose 24-bit noise is >= a floor
//           T, chosen so that about 1.5 * need + 32 of them pass (need =
//           the boundary's share of K, estimated from the maxima). After
//           each chunk, that chunk's space is handed to the next row's
//           bulk copy, so the next row loads while this one finishes;
//   list    if fewer than K nodes are above L, kth = L (the plateau, one
//           pass); else kth is the K-th key of the list (a bitonic sort).
//           Every list entry gets the composite key (class << 32 | ~col)
//           with the float compares of JAX, a bitonic network sorts them
//           descending with the scores as payload (one entry per thread,
//           partners within a warp by shuffles), and the first K are the
//           outputs.
//
// The list is exact when it holds every node whose composite key can
// reach the first K: every node above L, and enough boundary nodes at or
// above the floor (above + taken >= K). Pass 2 counts both; if the list
// overflowed or came up short it is rebuilt once from device memory with
// a floor from the exact counts, and if that fails too (or L is a signed
// zero, where float equality joins two keys) the row takes the exact
// path. The exact path, and every row when K > kFastK, is the general
// radix selection: four 8-bit digit passes for kth, three for the noise
// threshold, column passes on noise ties, a pick pass, and a bitonic sort
// of the K picks (in shared memory where they fit, else in place in the
// cand / cand_scores outputs, so nothing of size (P,N) is allocated).
// When K > kFastK, the first digit pass also fills a shared-memory copy of
// the row for the later passes where the K keys and the row fit (K*8 +
// N*4); a list-path row at a signed zero takes the exact path on the
// row's cache. Only a row whose rebuilt list still fails reads it from
// device memory in every pass (the cache already holds the next row).
//
// Layout. One block of 1024 threads per SM walks rows (grid = min(T*P,
// SMs)) when the row and the list fit in shared memory (N*4 + 12 KB, up
// to N = 54,000); else one block per row reads the row from device
// memory (L2) in both passes. The launcher reads the device's attributes
// once per device.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/shortlist_timing.py,
// PERF.md): 0.232 ms at 1024 x 53248, K=128 (the bench batch), against
// 0.870 ms for the radix kernel it replaces, in turns; 3.5x the byte
// bound. Clock stamps put the time in the instructions of the two passes
// (about 12k and 30k cycles per row) and the list's sort (about 12k),
// not in the row's bytes (about 2.5k cycles of waiting per row).
//
// Interface: a plain C function that launches on the caller's stream and
// returns the cudaError_t of the launch, or kNoLaunch (-1) for an empty
// batch. It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <functional>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kChunks = 8;     // bulk copies (and mbarriers) per row
constexpr int kCap = 1024;     // list entries
constexpr int kFastK = 384;    // the list path's largest K
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr int kMaxDevices = 64;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kAbove = 1u << 24;  // the class above any 24-bit noise
constexpr uint32_t kPosZero = 0x80000000u;  // order keys of +0.0, -0.0
constexpr uint32_t kNegZero = 0x7fffffffu;
constexpr size_t kListBytes = static_cast<size_t>(kCap) * 12;

enum Mode { kExact = 0, kListGlobal = 1, kListCached = 2 };
// What the exact mode keeps in shared memory.
enum ExactSmem { kNothing = 0, kKeys = 1, kKeysAndRow = 2 };

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

// The total order of lax.top_k: -0.0 maps below +0.0.
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(s);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float order_key_inv(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: a bulk copy of bytes (a multiple of 16, both addresses
// 16-byte aligned) from device memory into shared memory, completing the
// current phase of bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// hist[bin] += 1 for every lane with act, one atomic per distinct bin of
// the warp. Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin,
                                         bool act) {
  const uint32_t m = __ballot_sync(kFull, act);
  if (m == 0u) return;
  if (act) {
    const uint32_t peers = __match_any_sync(m, bin);
    if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
  }
}

// One warp: the bin that holds the krem-th node counted from the top bin
// (desc) or the bottom bin; writes {bin, krem within it, nodes in it}.
__device__ void select_bin(const uint32_t* hist, uint32_t krem, bool desc,
                           uint32_t* out) {
  const int lane = threadIdx.x & 31;
  uint32_t c[8];
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = lane * 8 + q;
    c[q] = hist[desc ? kBins - 1 - p : p];
    sum += c[q];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  uint32_t acc = incl - sum;
  if (acc < krem && krem <= incl) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (acc < krem && krem <= acc + c[q]) {
        const int p = lane * 8 + q;
        out[0] = desc ? kBins - 1 - p : p;
        out[1] = krem - acc;
        out[2] = c[q];
      }
      acc += c[q];
    }
  }
}

// f(column, in range, score) over columns [lo, hi) of the row, eight loads
// in flight per thread; every thread runs the same number of iterations
// (f may use the warp).
template <typename F>
__device__ __forceinline__ void for_cols(const float* row, int lo, int hi,
                                         F f) {
  constexpr int kU = 8;
  for (int base = lo; base < hi; base += kU * kThreads) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kThreads + static_cast<int>(threadIdx.x);
      v[u] = j < hi ? row[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kThreads + static_cast<int>(threadIdx.x);
      f(j, j < hi, v[u]);
    }
  }
}

// Bitonic network over keys[0, n), descending, with every block sorted the
// same way: each merge opens with the mirror compare, so a comparator
// whose partner lies past n compares with a virtual -inf and is skipped.
// get/put access entry a (a payload moves with its key).
template <typename Get, typename Put>
__device__ void bitonic_desc(int n, Get get, Put put) {
  int npow = 1;
  while (npow < n) npow <<= 1;
  for (int size = 2; size <= npow; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int a = threadIdx.x; a < npow; a += kThreads) {
        const int b = stride == size >> 1 ? a ^ (size - 1) : a ^ stride;
        if (b > a && b < n) {
          const uint64_t ka = get(a), kb = get(b);
          if (kb > ka) put(a, b, kb, ka);
        }
      }
      __syncthreads();
    }
  }
}

// The list path's sort: entries [0, n) of keys (and pay) descending,
// entries past n counting as 0 (below every real key). One entry per
// thread in registers; partners within a warp by shuffles, others through
// shared memory.
__device__ void sort_list(uint64_t* keys, uint32_t* pay, int n) {
  const int a = threadIdx.x;
  int npow = 1;
  while (npow < n) npow <<= 1;
  const bool act = a < npow;
  const bool warp_act = (a & ~31) < npow;  // warps past npow idle
  uint64_t k = a < n ? keys[a] : 0;
  uint32_t p = a < n ? pay[a] : 0u;
  for (int size = 2; size <= npow; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      // The merge's first step pairs a with its mirror in the block.
      const int mask = stride == size >> 1 ? size - 1 : stride;
      uint64_t kb = k;
      uint32_t pb = p;
      if (mask < 32) {
        if (!warp_act) continue;
        kb = __shfl_xor_sync(kFull, k, mask);
        pb = __shfl_xor_sync(kFull, p, mask);
      } else {
        __syncthreads();
        if (act) {
          keys[a] = k;
          pay[a] = p;
        }
        __syncthreads();
        kb = act ? keys[a ^ mask] : 0;
        pb = act ? pay[a ^ mask] : 0u;
      }
      const bool lower = (a & stride) == 0;  // a < partner: keep the larger
      if (lower ? kb > k : kb < k) {
        k = kb;
        p = pb;
      }
    }
  }
  __syncthreads();
  if (a < n) {
    keys[a] = k;
    pay[a] = p;
  }
  __syncthreads();
}

struct Shared {
  uint64_t bar[kChunks];
  uint32_t hist[kBins];
  uint32_t sums[3][kWarps];
  uint32_t sel[3];
  uint32_t count;
};

// The block's sums of (x, y, z); every thread gets them.
__device__ __forceinline__ void block_sum3(Shared& sh, uint32_t& x,
                                           uint32_t& y, uint32_t& z) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(kFull, x);
  y = __reduce_add_sync(kFull, y);
  z = __reduce_add_sync(kFull, z);
  if (lane == 0) {
    sh.sums[0][warp] = x;
    sh.sums[1][warp] = y;
    sh.sums[2][warp] = z;
  }
  __syncthreads();
  const bool w = lane < kWarps;
  x = __reduce_add_sync(kFull, w ? sh.sums[0][lane] : 0u);
  y = __reduce_add_sync(kFull, w ? sh.sums[1][lane] : 0u);
  z = __reduce_add_sync(kFull, w ? sh.sums[2][lane] : 0u);
  __syncthreads();
}

// The noise floor T at which about 1.5 * need + 32 of b uniform 24-bit
// noises are >= T.
__device__ __forceinline__ uint32_t noise_floor(uint32_t need, uint32_t b) {
  const uint64_t want = need + need / 2 + 32;
  if (want >= b) return 0;
  return kAbove - static_cast<uint32_t>((want << 24) / b);
}

// The general radix selection of row i, as the file's header describes.
// src: the row (in device memory, or already in shared memory); cache:
// shared memory that the first pass fills with the row for the later
// passes, or null to read src in every pass. keys: K 64-bit sort keys in
// shared memory, or null to sort in place in the outputs.
__device__ void select_exact(Shared& sh, const float* src, float* cache,
                             uint32_t seed, uint32_t i, int N, int K,
                             uint64_t* keys, int32_t* crow, float* csrow,
                             float* kth_out, float* kthn_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* cshi = reinterpret_cast<uint32_t*>(csrow);
  const float* row = cache != nullptr ? cache : src;

  // One digit pass: the histogram of digit(j) over the nodes with take(j),
  // then the bin of the krem-th node. Returns krem within that bin; the
  // bin and its count land in sh.sel. The first pass reads src and fills
  // the cache.
  bool first = true;
  auto pass = [&](uint32_t krem, bool desc, auto digit) {
    if (tid < kBins) sh.hist[tid] = 0;
    __syncthreads();
    const bool fill = first && cache != nullptr;
    for_cols(first ? src : row, 0, N, [&](int j, bool in, float s) {
      if (fill && in) cache[j] = s;
      uint32_t d = 0;
      const bool act = digit(j, in, s, d);
      hist_add(sh.hist, d, act);
    });
    __syncthreads();
    first = false;
    if (tid < 32) select_bin(sh.hist, krem, desc, sh.sel);
    __syncthreads();
    return sh.sel[1];
  };

  // kth: the K-th largest order key, four 8-bit digits.
  uint32_t prefix = 0, pmask = 0, krem = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    krem = pass(krem, true, [&](int, bool in, float s, uint32_t& d) {
      const uint32_t key = order_key(s);
      d = (key >> shift) & 255u;
      return in && (key & pmask) == prefix;
    });
    prefix |= sh.sel[0] << shift;
    pmask |= 255u << shift;
  }
  const float kth = order_key_inv(prefix);

  // above, need and the noise threshold t over the boundary.
  if (tid == 0) sh.count = 0;
  uint32_t t = 0, tmask = 0, tcount = 0;
  for (int shift = 16; shift >= 0; shift -= 8) {
    if (tid < kBins) sh.hist[tid] = 0;
    __syncthreads();
    for_cols(row, 0, N, [&](int j, bool in, float s) {
      if (shift == 16) {
        const uint32_t b = __ballot_sync(kFull, in && s > kth);
        if (lane == 0 && b) atomicAdd(&sh.count, __popc(b));
      }
      const bool bnd = in && s == kth;
      const uint32_t nz = bnd ? noise_key(seed, i, j) : 0u;
      hist_add(sh.hist, (nz >> shift) & 255u, bnd && (nz & tmask) == t);
    });
    __syncthreads();
    if (shift == 16) krem = K - sh.count;  // need >= 1
    if (tid < 32) select_bin(sh.hist, krem, true, sh.sel);
    __syncthreads();
    t |= sh.sel[0] << shift;
    tmask |= 255u << shift;
    krem = sh.sel[1];
    tcount = sh.sel[2];
  }
  // The lowest krem columns among the boundary nodes with noise t.
  uint32_t ct = 0xffffffffu;
  if (tcount > krem) {
    uint32_t cmask = 0;
    ct = 0;
    int top = 0;
    while (top < 24 && (static_cast<uint32_t>(N - 1) >> (top + 8)) != 0u)
      top += 8;
    for (int shift = top; shift >= 0; shift -= 8) {
      krem = pass(krem, false, [&](int j, bool in, float s, uint32_t& d) {
        const uint32_t c = static_cast<uint32_t>(j);
        d = (c >> shift) & 255u;
        return in && s == kth && (c & cmask) == ct &&
               noise_key(seed, i, j) == t;
      });
      ct |= sh.sel[0] << shift;
      cmask |= 255u << shift;
    }
  }

  // The K picks, their keys, then the sort.
  if (tid == 0) sh.count = 0;
  __syncthreads();
  for_cols(row, 0, N, [&](int j, bool in, float s) {
    uint32_t cls = kAbove;
    bool take = in && s > kth;
    if (in && s == kth) {
      cls = noise_key(seed, i, j);
      take = cls > t || (cls == t && static_cast<uint32_t>(j) <= ct);
    }
    const uint32_t m = __ballot_sync(kFull, take);
    if (m == 0u) return;
    uint32_t base = 0;
    if (lane == __ffs(m) - 1) base = atomicAdd(&sh.count, __popc(m));
    base = __shfl_sync(kFull, base, __ffs(m) - 1);
    if (take) {
      const uint32_t pos = base + __popc(m & ((1u << lane) - 1u));
      if (keys != nullptr) {
        keys[pos] = (static_cast<uint64_t>(cls) << 32) |
                    ~static_cast<uint32_t>(j);
      } else {
        cshi[pos] = cls;
        crow[pos] = static_cast<int32_t>(~static_cast<uint32_t>(j));
      }
    }
  });
  __syncthreads();

  auto get = [&](int a) -> uint64_t {
    if (keys != nullptr) return keys[a];
    return (static_cast<uint64_t>(cshi[a]) << 32) |
           static_cast<uint32_t>(crow[a]);
  };
  bitonic_desc(K, get, [&](int a, int b, uint64_t va, uint64_t vb) {
    if (keys != nullptr) {
      keys[a] = va;
      keys[b] = vb;
    } else {
      cshi[a] = static_cast<uint32_t>(va >> 32);
      crow[a] = static_cast<int32_t>(static_cast<uint32_t>(va));
      cshi[b] = static_cast<uint32_t>(vb >> 32);
      crow[b] = static_cast<int32_t>(static_cast<uint32_t>(vb));
    }
  });

  for (int k = tid; k < K; k += kThreads) {
    const uint32_t col = ~static_cast<uint32_t>(get(k));
    crow[k] = static_cast<int32_t>(col);
    csrow[k] = row[col];
  }
  if (tid == 0) {
    *kth_out = kth;
    *kthn_out = __fmul_rn(static_cast<float>(t), 1.0f / 16777216.0f);
  }
  __syncthreads();
}


// Row r's seed and its pod row within its lane.
__device__ __forceinline__ void row_lane(const uint32_t* seeds, uint32_t seed,
                                         uint32_t P, uint32_t r, uint32_t& sd,
                                         uint32_t& pod) {
  const uint32_t t = r / P;
  sd = seeds != nullptr ? seeds[t] : seed;
  pod = r - t * P;
}

__global__ void __launch_bounds__(kThreads, 1)
    shortlist_select_kernel(const float* __restrict__ scores,
                            const uint32_t* __restrict__ seeds, uint32_t seed,
                            int P, int rows, int N, int K, int mode,
                            int exact_smem, int32_t* cand, float* kth_out,
                            float* kthn_out, float* cand_scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint32_t lt = (1u << lane) - 1u;

  if (mode == kExact) {  // one row per block: the keys, then the row
    const uint32_t i = blockIdx.x;
    uint32_t sd, pod;
    row_lane(seeds, seed, P, i, sd, pod);
    float* cache = reinterpret_cast<float*>(smem + static_cast<size_t>(K) * 8);
    select_exact(sh, scores + static_cast<size_t>(i) * N,
                 exact_smem == kKeysAndRow ? cache : nullptr, sd, pod, N, K,
                 exact_smem != kNothing ? reinterpret_cast<uint64_t*>(smem)
                                        : nullptr,
                 cand + static_cast<size_t>(i) * K,
                 cand_scores + static_cast<size_t>(i) * K, kth_out + i,
                 kthn_out + i);
    return;
  }

  // The list (64-bit keys and a 32-bit payload), then the row's cache.
  uint64_t* lkeys = reinterpret_cast<uint64_t*>(smem);
  uint32_t* lpay = reinterpret_cast<uint32_t*>(smem + kCap * 8);
  float* s_row = reinterpret_cast<float*>(smem + kListBytes);
  const bool cached = mode == kListCached;
  // Chunks of whole strides, so thread t holds the columns j = t mod
  // kThreads (a multiple of 4 columns: 16-byte copies).
  const int ce = ((N + kChunks - 1) / kChunks + kThreads - 1) / kThreads *
                 kThreads;
  const int nchunks = (N + ce - 1) / ce;
  auto issue = [&](int c, uint32_t r) {  // one thread
    const int lo = c * ce, hi = min(N, lo + ce);
    bulk_load(s_row + lo, scores + static_cast<size_t>(r) * N + lo,
              static_cast<uint32_t>(hi - lo) * 4u, &sh.bar[c]);
  };
  if (cached) {
    if (tid == 0) {
      for (int c = 0; c < kChunks; ++c) mbar_init(&sh.bar[c]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < nchunks; ++c) issue(c, blockIdx.x);
  }

  uint32_t parity = 0;
  for (uint32_t i = blockIdx.x; i < static_cast<uint32_t>(rows);
       i += gridDim.x, parity ^= 1u) {
    uint32_t sd, pod;  // the lane's seed, the pod's row in its lane
    row_lane(seeds, seed, P, i, sd, pod);
    const float* g = scores + static_cast<size_t>(i) * N;
    const uint32_t next = i + gridDim.x;
    int32_t* crow = cand + static_cast<size_t>(i) * K;
    float* csrow = cand_scores + static_cast<size_t>(i) * K;

    // Pass 1: each thread's largest order key and its multiplicity. (Each
    // pass is written out for the cache and for device memory, so that the
    // compiler emits shared-memory loads for the one.)
    uint32_t mx = 0, cm = 0;
    auto pass1 = [&](const float* from) {
      for (int c = 0; c < nchunks; ++c) {
        if (cached) mbar_wait(&sh.bar[c], parity);
        for_cols(from, c * ce, min(N, (c + 1) * ce),
                 [&](int, bool in, float s) {
                   const uint32_t key = order_key(s);
                   if (in && key > mx) {
                     mx = key;
                     cm = 1;
                   } else if (in && key == mx) {
                     ++cm;
                   }
                 });
      }
    };
    if (cached) {
      pass1(s_row);
    } else {
      pass1(g);
    }
    // L: the K-th largest thread maximum (threads without nodes hold 0),
    // by bisection below the bits that all maxima of nodes share.
    uint32_t hi = __reduce_max_sync(kFull, mx);
    uint32_t lo = __reduce_min_sync(kFull, tid < N ? mx : 0xffffffffu);
    if (lane == 0) {
      sh.sums[0][tid >> 5] = hi;
      sh.sums[1][tid >> 5] = lo;
    }
    __syncthreads();
    hi = __reduce_max_sync(kFull, lane < kWarps ? sh.sums[0][lane] : 0u);
    lo = __reduce_min_sync(kFull,
                           lane < kWarps ? sh.sums[1][lane] : 0xffffffffu);
    __syncthreads();
    const int top = hi == lo ? -1 : 31 - __clz(hi ^ lo);
    uint32_t L = top < 0 ? hi : hi & ~(0xffffffffu >> (31 - top));
    for (int bit = top; bit >= 0; --bit) {
      const uint32_t c = L | (1u << bit);
      if (__syncthreads_count(mx >= c) >= K) L = c;
    }
    const uint32_t over = __syncthreads_count(mx > L);  // <= K - 1
    uint32_t at_l = mx == L ? cm : 0u, u0 = 0, u1 = 0;
    block_sum3(sh, at_l, u0, u1);  // a lower bound on #(key == L)

    // Pass 2: the list of every node above L and the nodes at L with
    // noise >= T. Returns #(key > L), #(key == L), #(taken at L).
    auto compact = [&](const float* from, bool handover, uint32_t T,
                       uint32_t& a, uint32_t& e, uint32_t& et) {
      if (tid == 0) sh.count = 0;
      __syncthreads();
      a = e = et = 0;
      for (int c = 0; c < nchunks; ++c) {
        for_cols(from, c * ce, min(N, (c + 1) * ce),
                 [&](int j, bool in, float s) {
                   const uint32_t key = order_key(s);
                   const bool up = in && key > L;
                   bool take = up;
                   if (in && key == L) {
                     ++e;
                     take = noise_key(sd, pod, j) >= T;
                     et += take;
                   }
                   a += up;
                   const uint32_t m = __ballot_sync(kFull, take);
                   if (m == 0u) return;
                   uint32_t base = 0;
                   if (lane == __ffs(m) - 1)
                     base = atomicAdd(&sh.count, __popc(m));
                   base = __shfl_sync(kFull, base, __ffs(m) - 1);
                   const uint32_t pos = base + __popc(m & lt);
                   if (take && pos < kCap)
                     lkeys[pos] = (static_cast<uint64_t>(key) << 32) |
                                  ~static_cast<uint32_t>(j);
                 });
        if (handover) {  // chunk c is read: the next row may land there
          __syncthreads();
          if (tid == 0 && next < static_cast<uint32_t>(rows)) issue(c, next);
        }
      }
      block_sum3(sh, a, e, et);
    };
    auto fits = [&](uint32_t a, uint32_t et) {
      return a + et <= static_cast<uint32_t>(kCap) &&
             (a >= static_cast<uint32_t>(K) ||
              a + et >= static_cast<uint32_t>(K));
    };

    // A signed zero at L joins two keys under float equality: exact path.
    bool ok = L != kPosZero && L != kNegZero;
    uint32_t a = 0, e = 0, et = 0;
    if (ok) {
      if (cached) {
        compact(s_row, true, noise_floor(K - over, at_l), a, e, et);
      } else {
        compact(g, false, noise_floor(K - over, at_l), a, e, et);
      }
      ok = fits(a, et);
      if (!ok) {  // once more from device memory, floor from exact counts
        compact(g, false,
                a >= static_cast<uint32_t>(K) ? kAbove
                                              : noise_floor(K - a, e),
                a, e, et);
        ok = fits(a, et);
      }
    } else if (cached) {  // the exact path on the cached row, then hand it on
      select_exact(sh, s_row, nullptr, sd, pod, N, K, lkeys, crow, csrow,
                   kth_out + i, kthn_out + i);
      if (tid == 0 && next < static_cast<uint32_t>(rows))
        for (int c = 0; c < nchunks; ++c) issue(c, next);
      continue;
    }
    // A failed list: the cache, if any, already holds the next row.
    if (!ok) {
      select_exact(sh, g, nullptr, sd, pod, N, K, lkeys, crow, csrow,
                   kth_out + i, kthn_out + i);
      continue;
    }

    // The list: kth, the composite keys, the sort, the first K.
    const int n = static_cast<int>(a + et);
    uint32_t kkey = L;
    if (a >= static_cast<uint32_t>(K)) {  // kth lies above L
      sort_list(lkeys, lpay, n);
      kkey = static_cast<uint32_t>(lkeys[K - 1] >> 32);
      __syncthreads();  // read by all before the keys are rewritten
    }
    const float kth = order_key_inv(kkey);
    for (int x = tid; x < n; x += kThreads) {
      const uint64_t v = lkeys[x];
      const float s = order_key_inv(static_cast<uint32_t>(v >> 32));
      const uint32_t col = ~static_cast<uint32_t>(v);
      uint64_t cls = 0;  // below kth: 0 sorts last
      if (s > kth) {
        cls = kAbove + 1;
      } else if (s == kth) {
        cls = noise_key(sd, pod, col) + 1;
      }
      lkeys[x] = (cls << 32) | static_cast<uint32_t>(v);
      lpay[x] = __float_as_uint(s);
    }
    __syncthreads();
    sort_list(lkeys, lpay, n);
    for (int k = tid; k < K; k += kThreads) {
      crow[k] = static_cast<int32_t>(~static_cast<uint32_t>(lkeys[k]));
      csrow[k] = __uint_as_float(lpay[k]);
    }
    if (tid == 0) {
      kth_out[i] = kth;
      kthn_out[i] = __fmul_rn(
          static_cast<float>(static_cast<uint32_t>(lkeys[K - 1] >> 32) - 1u),
          1.0f / 16777216.0f);
    }
    __syncthreads();
  }
}

// The device's attributes, read once per device.
struct DeviceInfo {
  cudaError_t err = cudaSuccess;
  int sms = 0;
  size_t budget = 0;  // dynamic shared memory a block may use
};
DeviceInfo g_info[kMaxDevices];
std::once_flag g_once[kMaxDevices];

void read_device(int dev, DeviceInfo& d) {
  int optin = 0;
  cudaFuncAttributes attr;
  d.err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (d.err == cudaSuccess)
    d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (d.err == cudaSuccess)
    d.err = cudaFuncGetAttributes(&attr, shortlist_select_kernel);
  if (d.err != cudaSuccess) return;
  d.budget = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  d.err = cudaFuncSetAttribute(shortlist_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(d.budget));
}

}  // namespace

// seeds: null (one lane, the scalar seed) or T u32 seeds in device memory.
extern "C" int shortlist_select_launch(const float* scores,
                                       const uint32_t* seeds, uint32_t seed,
                                       int T, int P, int N, int K,
                                       int32_t* cand, float* kth,
                                       float* kth_noise, float* cand_scores,
                                       void* stream) {
  if (T < 1 || P < 0 || N < 1 || K < 1 || K > N ||
      (seeds == nullptr && T != 1) ||
      static_cast<long long>(T) * P > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (P == 0) return kNoLaunch;
  const int rows = T * P;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[dev];
  std::call_once(g_once[dev], read_device, dev, std::ref(d));
  if (d.err != cudaSuccess) return d.err;
  const size_t rowb = static_cast<size_t>(N) * 4;
  const size_t keyb = static_cast<size_t>(K) * 8;
  int mode = kListGlobal, exact_smem = kNothing, grid = rows;
  size_t dyn = kListBytes;
  if (K > kFastK) {
    mode = kExact;
    if (keyb + rowb <= d.budget) {
      exact_smem = kKeysAndRow;
      dyn = keyb + rowb;
    } else if (keyb <= d.budget) {
      exact_smem = kKeys;
      dyn = keyb;
    } else {
      dyn = 0;
    }
  } else if (N % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0 &&
             kListBytes + rowb <= d.budget) {
    mode = kListCached;  // one block per SM walks the rows
    dyn = kListBytes + rowb;
    grid = rows < d.sms ? rows : d.sms;
  }
  shortlist_select_kernel<<<grid, kThreads, dyn,
                            static_cast<cudaStream_t>(stream)>>>(
      scores, seeds, seed, P, rows, N, K, mode, exact_smem, cand, kth,
      kth_noise, cand_scores);
  return cudaGetLastError();
}

extern "C" const char* shortlist_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
