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
//
// The per-row algorithm (no (P,N) lattice; the noise is computed inline
// from (seed, row, column) in native u32):
//   1. kth by a radix select on the 32-bit order-preserving key of the
//      scores: four 8-bit digit passes, each a shared-memory histogram of
//      the nodes that match the digits chosen so far;
//   2. above = #(score > kth) <= K-1 and the boundary {score == kth}
//      (float compares, as in JAX), so need = K - above >= 1;
//   3. t = the need-th largest 24-bit noise on the boundary, by three more
//      digit passes; where more boundary nodes carry noise t than the
//      slots left, the lowest columns among them, by digit passes over the
//      column (rare: the noise is 24 bits);
//   4. every node above kth, every boundary node with noise > t, and those
//      with noise t up to the chosen column (exactly K) write the 64-bit
//      key (class << 32 | ~column), class = 2^24 above kth and the noise
//      on the boundary; a bitonic network sorts the K keys descending,
//      which is lax.top_k's order; kth_noise = t * 2^-24 (exact).
//
// Bound. The bytes the function must move are the scores once (P*N*4:
// 218 MB at 1024 x 53248, 0.065 ms at 3.35 TB/s) and the outputs. One
// block of 1024 threads per row; the row is read from device memory once,
// with eight loads in flight per thread, into shared memory (213 KB at
// N = 53248), and every later pass runs over shared memory. Histogram
// adds are aggregated per warp (__match_any_sync) because scheduler scores
// plateau: at bench-50k's first batch most of a row shares a few values.
// The sort is over K entries only, in shared memory. Where the row does
// not fit beside the sort keys, later passes re-read it from device
// memory (L2); where the K keys do not fit either (K near N at large N),
// they are sorted in place in the cand / cand_scores outputs (the key's
// two halves), so nothing of size (P,N) is ever allocated.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py,
// tools/shortlist_timing.py, PERF.md): 0.873-0.897 ms at 1024 x 53248,
// K=128, against 8.50-8.72 ms for the PyTorch selection and 0.786-0.798
// ms for one torch.topk of the scores; 13x its byte bound. Each row makes
// eight passes over shared memory, each a ballot and a __match_any_sync
// per node: the passes, not the bytes, set the pace.
//
// Interface: a plain C function that launches on the caller's stream and
// returns the cudaError_t of the launch, or kNoLaunch (-1) for an empty
// batch. It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kU = 8;  // elements per thread in flight in a row pass
constexpr int kBins = 256;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kAbove = 1u << 24;  // the class above any 24-bit noise

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

// f(column, in range, score) over the row, kU loads in flight per thread;
// every thread runs the same number of iterations (f may use the warp).
template <typename F>
__device__ __forceinline__ void for_row(const float* row, int N, F f) {
  for (int base = 0; base < N; base += kU * kThreads) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kThreads + static_cast<int>(threadIdx.x);
      v[u] = j < N ? row[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = base + u * kThreads + static_cast<int>(threadIdx.x);
      f(j, j < N, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    shortlist_select_kernel(const float* __restrict__ scores, uint32_t seed,
                            int N, int K, int cache_row, int sort_in_smem,
                            int32_t* cand, float* kth_out, float* kthn_out,
                            float* cand_scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_hist[kBins];
  __shared__ uint32_t s_sel[3];
  __shared__ uint32_t s_count;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const uint32_t i = blockIdx.x;
  const float* g = scores + static_cast<size_t>(i) * N;
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(smem);
  float* s_row = reinterpret_cast<float*>(
      smem + (sort_in_smem ? static_cast<size_t>(K) * 8 : 0));
  const float* row = cache_row ? s_row : g;
  int32_t* crow = cand + static_cast<size_t>(i) * K;
  float* csrow = cand_scores + static_cast<size_t>(i) * K;
  uint32_t* cshi = reinterpret_cast<uint32_t*>(csrow);

  // One digit pass: the histogram of digit(j) over the nodes with take(j),
  // then the bin of the krem-th node. Returns krem within that bin; the
  // bin and its count land in s_sel.
  auto pass = [&](const float* src, bool fill, uint32_t krem, bool desc,
                  auto digit) {
    if (tid < kBins) s_hist[tid] = 0;
    __syncthreads();
    for_row(src, N, [&](int j, bool in, float s) {
      if (fill && in) s_row[j] = s;
      uint32_t d = 0;
      const bool act = digit(j, in, s, d);
      hist_add(s_hist, d, act);
    });
    __syncthreads();
    if (tid < 32) select_bin(s_hist, krem, desc, s_sel);
    __syncthreads();
    return s_sel[1];
  };

  // 1. kth: the K-th largest order key, four 8-bit digits.
  uint32_t prefix = 0, pmask = 0, krem = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    krem = pass(shift == 24 ? g : row, shift == 24 && cache_row, krem, true,
                [&](int, bool in, float s, uint32_t& d) {
                  const uint32_t key = order_key(s);
                  d = (key >> shift) & 255u;
                  return in && (key & pmask) == prefix;
                });
    prefix |= s_sel[0] << shift;
    pmask |= 255u << shift;
  }
  const float kth = order_key_inv(prefix);

  // 2-3. above, need and the noise threshold t over the boundary.
  if (tid == 0) s_count = 0;
  uint32_t t = 0, tmask = 0, tcount = 0;
  for (int shift = 16; shift >= 0; shift -= 8) {
    if (tid < kBins) s_hist[tid] = 0;
    __syncthreads();
    for_row(row, N, [&](int j, bool in, float s) {
      if (shift == 16) {
        const uint32_t b = __ballot_sync(kFull, in && s > kth);
        if (lane == 0 && b) atomicAdd(&s_count, __popc(b));
      }
      const bool bnd = in && s == kth;
      const uint32_t nz = bnd ? noise_key(seed, i, j) : 0u;
      hist_add(s_hist, (nz >> shift) & 255u, bnd && (nz & tmask) == t);
    });
    __syncthreads();
    if (shift == 16) krem = K - s_count;  // need >= 1
    if (tid < 32) select_bin(s_hist, krem, true, s_sel);
    __syncthreads();
    t |= s_sel[0] << shift;
    tmask |= 255u << shift;
    krem = s_sel[1];
    tcount = s_sel[2];
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
      krem = pass(row, false, krem, false,
                  [&](int j, bool in, float s, uint32_t& d) {
                    const uint32_t c = static_cast<uint32_t>(j);
                    d = (c >> shift) & 255u;
                    return in && s == kth && (c & cmask) == ct &&
                           noise_key(seed, i, j) == t;
                  });
      ct |= s_sel[0] << shift;
      cmask |= 255u << shift;
    }
  }

  // 4. the K picks, their keys, then the sort.
  if (tid == 0) s_count = 0;
  __syncthreads();
  for_row(row, N, [&](int j, bool in, float s) {
    uint32_t cls = kAbove;
    bool take = in && s > kth;
    if (in && s == kth) {
      cls = noise_key(seed, i, j);
      take = cls > t || (cls == t && static_cast<uint32_t>(j) <= ct);
    }
    const uint32_t m = __ballot_sync(kFull, take);
    if (m == 0u) return;
    uint32_t base = 0;
    if (lane == __ffs(m) - 1) base = atomicAdd(&s_count, __popc(m));
    base = __shfl_sync(kFull, base, __ffs(m) - 1);
    if (take) {
      const uint32_t pos = base + __popc(m & ((1u << lane) - 1u));
      if (sort_in_smem) {
        s_keys[pos] = (static_cast<uint64_t>(cls) << 32) |
                      ~static_cast<uint32_t>(j);
      } else {
        cshi[pos] = cls;
        crow[pos] = static_cast<int32_t>(~static_cast<uint32_t>(j));
      }
    }
  });
  __syncthreads();

  auto get = [&](int a) -> uint64_t {
    if (sort_in_smem) return s_keys[a];
    return (static_cast<uint64_t>(cshi[a]) << 32) |
           static_cast<uint32_t>(crow[a]);
  };
  auto put = [&](int a, uint64_t v) {
    if (sort_in_smem) {
      s_keys[a] = v;
    } else {
      cshi[a] = static_cast<uint32_t>(v >> 32);
      crow[a] = static_cast<int32_t>(static_cast<uint32_t>(v));
    }
  };
  // Bitonic network with every block sorted the same way (descending):
  // each merge starts by comparing a with its mirror, so a comparator
  // whose partner lies past K compares with a virtual -inf and is skipped.
  int npow = 1;
  while (npow < K) npow <<= 1;
  for (int size = 2; size <= npow; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int a = tid; a < npow; a += kThreads) {
        const int b = stride == size >> 1 ? a ^ (size - 1) : a ^ stride;
        if (b > a && b < K) {
          const uint64_t ka = get(a), kb = get(b);
          if (kb > ka) {
            put(a, kb);
            put(b, ka);
          }
        }
      }
      __syncthreads();
    }
  }

  for (int k = tid; k < K; k += kThreads) {
    const uint32_t col = ~static_cast<uint32_t>(get(k));
    crow[k] = static_cast<int32_t>(col);
    csrow[k] = row[col];
  }
  if (tid == 0) {
    kth_out[i] = kth;
    kthn_out[i] = __fmul_rn(static_cast<float>(t), 1.0f / 16777216.0f);
  }
}

}  // namespace

extern "C" int shortlist_select_launch(const float* scores, uint32_t seed,
                                       int P, int N, int K, int32_t* cand,
                                       float* kth, float* kth_noise,
                                       float* cand_scores, void* stream) {
  if (P < 0 || N < 1 || K < 1 || K > N) return cudaErrorInvalidValue;
  if (P == 0) return kNoLaunch;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, shortlist_select_kernel);
  if (err != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  const size_t keys = static_cast<size_t>(K) * 8;
  const size_t rowb = static_cast<size_t>(N) * 4;
  const int sort_in_smem = keys <= budget;
  size_t dyn = sort_in_smem ? keys : 0;
  const int cache_row = dyn + rowb <= budget;
  if (cache_row) dyn += rowb;
  err = cudaFuncSetAttribute(shortlist_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  shortlist_select_kernel<<<P, kThreads, dyn,
                            static_cast<cudaStream_t>(stream)>>>(
      scores, seed, N, K, cache_row, sort_in_smem, cand, kth, kth_noise,
      cand_scores);
  return cudaGetLastError();
}

extern "C" const char* shortlist_select_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
