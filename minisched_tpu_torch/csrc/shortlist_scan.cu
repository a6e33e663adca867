// The certified shortlist scan of one scheduling batch, for Hopper.
//
// Replaces the sequential stage of minisched_tpu/ops/select.py
// greedy_assign_shortlist (its lax.scan, select.py:238-279; not a Pallas
// kernel, an XLA scan). Same function, bit for bit. The parallel part,
// shortlist_select, is the kernel of csrc/shortlist_select.cu; it hands
// this kernel, per pod, K candidate columns with their scores and the
// bound (kth, kth_noise).
//
// Pods are taken in row order. For pod i:
//   1. a candidate fits when its current free row covers the request on
//      every axis;
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
// the scan must move are about 10.6 MB (candidates, their scores, the
// P*K*R gathered free values, free in and out): 3 us at 3.35 TB/s. The
// real limit is the chain of P dependent steps: pod i+1 must see the row
// pod i debited. The kernel's first design gathered every candidate row
// from the free matrix it was writing, in device memory, so each step paid
// two L2 round trips (the debit made visible at a named barrier, then the
// next gather) and two block barriers: 1.46-1.50 us per pod.
//
// Design: nothing on the chain touches device memory or a block barrier.
//   - The rows come from free0, which is never written (the caller may
//     still hold it), so they can be fetched ahead of the walk. Four
//     producer warps each take every fourth pod: they store its
//     candidates and their scores, copy its K candidate rows, its request
//     and bound (cp.async, 8-byte copies when R is even) into a ring of up
//     to 32 stages in shared memory, and find its best candidate by
//     (score, noise, column), fit or not. Stages are handed over with
//     mbarriers: full[s] completes when the copies have landed and the
//     stores are released, empty[s] when the walker is done with it.
//     Rows and the request are padded to 16 or 32 floats (+inf and -inf),
//     so the walker reads a row with 16-byte loads and compares every
//     axis without predicates.
//   - The batch's debits live in a shared-memory overlay: a bitmap of N
//     bits marks the debited columns, and an open-addressing table (four
//     entries per slot) maps such a column to a slot holding that row's
//     current free values. A row enters at its first debit as its free0
//     row minus the request; later debits subtract in pod order. A
//     candidate reads its row from the overlay when its column is there,
//     else from the ring: exactly the current free. At the end the block
//     writes the overlay rows into free_after (the launcher has copied
//     free0 there).
//   - One warp walks the pods. It checks the producers' best candidate
//     first: when that fits, it is the winner among the fitting ones, and
//     the step is that check, the certificate and the debit. Otherwise
//     every candidate is checked, four per lane at K <= 128 (candidates
//     past the ring's 128 are read from device memory, for K > 128), and
//     (score key, noise key, column) is reduced with __reduce_*_sync. The
//     winner's lane debits the overlay; only __syncwarp between pods.
//   - A failed certificate posts the pod at a named barrier; the walker and
//     eleven helper warps scan the full row as free0 (+) overlay (each
//     column's overlay row when present) and reduce through shared memory.
//   - Where the overlay (bitmap, table and P padded rows) does not fit
//     beside two ring stages, its rows live in free_after itself, in device
//     memory, with only the bitmap in shared memory (without room for the
//     bitmap, every candidate reads free_after). That layout is this
//     kernel's own choice for large P; tests/test_torch_kernel.py holds it
//     on the card.
//
// Lanes. One launch may serve T independent batches of the same P, N, K
// and R (the fused tenant step, minisched_tpu/ops/pipeline.py
// build_tenant_step's jax.vmap of the scan): every input and output gains
// a leading lane axis, contiguous per lane, and one block walks each lane
// (grid = T). A block takes about the whole shared memory of an SM, so the
// lanes' chains run side by side, one SM each, up to 132 at once. Lane t's
// seed is seeds[t] (a (T,) u32 array in device memory); with no seeds
// array (the per-batch launch, T = 1) the scalar seed serves. The
// layout (ring depth, overlay in shared or device memory) depends only on
// P, N, K and R, so it is chosen once for all lanes.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/shortlist_timing.py,
// chip_smoke.py, PERF.md): 0.588-0.595 ms at the main path's shape (0.57
// us per pod) against 1.499-1.546 ms for that first design in the same calls;
// with 125 repairs, 8.13 ms against 10.22 ms, about 60-67 us per repair.
// A first build in which the walker evaluated all 128 candidates per pod
// (no best-candidate check, predicated R-wide loads) took 2.46-2.89 ms:
// one warp is instruction-bound, so the step now does as little as the
// certificate allows, and the producers, who have time, do the rest.
//
// Exactness. Scores compare as order-preserving u32 keys (-0 mapped to +0,
// which float compare calls equal), the noise as its 24-bit integer
// x >> 8, which orders as the float (x >> 8) * 2^-24; the certificate
// compares wn as that float with kth_noise. Nothing is contracted to FMA:
// the only float arithmetic is the __fsub_rn debit.
//
// Interface: a plain C function that launches on the caller's stream and
// returns the cudaError_t of the launch, or kNoLaunch (-1) for empty
// batches, where it only copies free0 into free_after (one copy of all
// T lanes). It allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kProducerWarps = 4;       // warps 1-4
constexpr int kHelperWarp0 = 1 + kProducerWarps;  // warps 5-15: repairs
constexpr int kRepairWarps = kThreads / 32 - kProducerWarps;  // with warp 0
constexpr int kRepairThreads = kRepairWarps * 32;
constexpr int kRingK = 128;  // candidates per pod held in the ring
constexpr int kMaxStages = 32;
constexpr int kMaxR = 32;  // the kernel is built for R <= 16 and R <= 32
constexpr float kNeg = -3.0e38f;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kColMult = 0x85EBCA77u;
constexpr uint32_t kFull = 0xffffffffu;
// Named barriers (0 is __syncthreads), among the walker and the helpers:
// kBarPost, the walker posts a pod to repair (or the end); kBarRepair, the
// partial bests are in shared memory.
constexpr int kBarPost = 1;
constexpr int kBarRepair = 2;

struct Params {
  const float* scores;
  const int32_t* cand;
  const float* cand_scores;
  const float* kth;
  const float* kth_noise;
  const float* requests;
  const float* free0;
  float* free_after;
  int32_t* chosen;
  uint8_t* assigned;
  uint8_t* repaired;
  const uint32_t* seeds;  // T lane seeds in device memory, or null
  uint32_t seed;
  int P, N, K, R;
  int ring_k;        // min(K, kRingK)
  int stages;        // D
  int stage_bytes;   // one stage of the ring
  int off_cs, off_req, off_bound, off_top, off_rows;  // inside a stage
  int bitmap_words;  // the debited-column bitmap; 0: none (device layout)
  int off_table;     // the overlay table after the bitmap (shared layout)
  int table_bits;    // overlay table of 2^table_bits entries (shared layout)
  int pairs;         // R even and free0 8-byte aligned: 8-byte row copies
};

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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
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

// One stage of the ring: pod i's candidates, their scores, its request and
// bound, and the candidates' free0 rows. Rows and the request are padded to
// MaxR floats (rows with +inf, the request with -inf, written once), so
// the walker reads them with 16-byte loads and compares every axis.
struct Stage {
  int32_t* cand;
  float* cs;
  float* req;
  float* bound;  // kth, kth_noise
  int4* top;     // the best candidate: column, score key, noise key, index
  float* rows;
};

__device__ __forceinline__ Stage stage_at(unsigned char* ring,
                                          const Params& p, int s) {
  unsigned char* b = ring + static_cast<size_t>(s) * p.stage_bytes;
  return Stage{reinterpret_cast<int32_t*>(b),
               reinterpret_cast<float*>(b + p.off_cs),
               reinterpret_cast<float*>(b + p.off_req),
               reinterpret_cast<float*>(b + p.off_bound),
               reinterpret_cast<int4*>(b + p.off_top),
               reinterpret_cast<float*>(b + p.off_rows)};
}

// The batch's debited rows. A bitmap of N bits marks the debited columns
// (the device layout may have none: then every column counts as debited).
// Shared layout: a table of {column, slot} entries (column -1: empty, at
// least four per slot, linear probing), slot_col and the slots' rows
// (padded to MaxR floats) in shared memory. Device layout: the rows are
// free_after's. Only the walker inserts.
template <int MaxR, bool kSharedRows>
struct Overlay {
  int2* table;
  uint32_t mask;
  int shift;
  int32_t* slot_col;
  float* rows;
  int* nslots;
  uint32_t* bitmap;
  float* free_after;
  int R;

  __device__ __forceinline__ uint32_t hash(int c) const {
    return (static_cast<uint32_t>(c) * 0x9E3779B1u) >> shift;
  }
  __device__ __forceinline__ bool debited(int c) const {
    if (!kSharedRows && bitmap == nullptr) return true;
    return (bitmap[c >> 5] >> (c & 31)) & 1u;
  }
  // The slot of a debited column.
  __device__ __forceinline__ int slot_of(int c) const {
    if (!kSharedRows) return c;
    uint32_t h = hash(c);
    while (table[h].x != c) h = (h + 1) & mask;
    return table[h].y;
  }
  // The column's slot, or -1 when its row is not in the overlay.
  __device__ __forceinline__ int lookup(int c) const {
    return debited(c) ? slot_of(c) : -1;
  }
  __device__ __forceinline__ float* row(int c, int slot) const {
    return kSharedRows ? rows + static_cast<size_t>(slot) * MaxR
                       : free_after + static_cast<size_t>(c) * R;
  }
  __device__ __forceinline__ int insert(int c) const {
    if (bitmap != nullptr) bitmap[c >> 5] |= 1u << (c & 31);
    if (!kSharedRows) return c;
    const int slot = *nslots;
    *nslots = slot + 1;
    uint32_t h = hash(c);
    while (table[h].x >= 0) h = (h + 1) & mask;
    table[h] = make_int2(c, slot);
    slot_col[slot] = c;
    return slot;
  }
};

// A row of R floats (any stride), padded with +inf.
template <int MaxR>
__device__ __forceinline__ void load_row(float (&v)[MaxR], const float* f,
                                         int R) {
#pragma unroll
  for (int r = 0; r < MaxR; ++r)
    v[r] = r < R ? f[r] : __int_as_float(0x7f800000);
}

// A padded row of MaxR floats, 16-byte aligned.
template <int MaxR>
__device__ __forceinline__ void load_padded(float (&v)[MaxR], const float* f) {
  const float4* f4 = reinterpret_cast<const float4*>(f);
#pragma unroll
  for (int q = 0; q < MaxR / 4; ++q) {
    const float4 x = f4[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// Does the row cover the request on every axis (pads: +inf >= -inf)?
template <int MaxR>
__device__ __forceinline__ bool covers(const float (&v)[MaxR],
                                       const float (&req)[MaxR]) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < MaxR; ++r) ok &= v[r] >= req[r];
  return ok;
}

// The row's debit: dst = v - req, one __fsub_rn per axis (v is the row's
// current value). A padded dst is written whole (its pads stay +inf).
template <int MaxR>
__device__ __forceinline__ void debit(float* dst, bool dst_padded,
                                      const float (&v)[MaxR],
                                      const float (&req)[MaxR], int R) {
  float d[MaxR];
#pragma unroll
  for (int r = 0; r < MaxR; ++r) d[r] = __fsub_rn(v[r], req[r]);
  if (dst_padded) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < MaxR / 4; ++q)
      d4[q] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < MaxR; ++r)
      if (r < R) dst[r] = d[r];
  }
}

// A row into v: padded (16-byte loads) or of R floats.
template <int MaxR>
__device__ __forceinline__ void load_any(float (&v)[MaxR], const float* f,
                                         bool padded, int R) {
  if (padded)
    load_padded<MaxR>(v, f);
  else
    load_row<MaxR>(v, f, R);
}

// Producer warp w (0-based) fills the ring for pods w, w + 4, ...: lane l
// holds candidates l, l + 32, ... (loaded while the warp waits for the
// stage and fills the one before), stores them and their scores, copies
// their rows and the pod's request and bound with cp.async, and finds the
// best candidate by (score, noise, column), fit or not, for the walker.
template <int MaxR>
__device__ void produce(const Params& p, unsigned char* ring, uint64_t* full,
                        uint64_t* empty, int w) {
  constexpr int kQ = kRingK / 32;
  const int lane = threadIdx.x & 31;
  auto load = [&](int i, int (&c)[kQ], float (&sc)[kQ]) {
    const size_t at = static_cast<size_t>(i) * p.K;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = lane + 32 * q;
      const bool in = i < p.P && k < p.ring_k;
      c[q] = in ? __ldg(p.cand + at + k) : -1;
      sc[q] = in ? __ldg(p.cand_scores + at + k) : 0.f;
    }
  };
  int nc[kQ];
  float ns[kQ];
  load(w, nc, ns);
  int s = w % p.stages, round = w / p.stages;
  for (int i = w; i < p.P; i += kProducerWarps) {
    int c[kQ];
    float sc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      c[q] = nc[q];
      sc[q] = ns[q];
    }
    load(i + kProducerWarps, nc, ns);
    if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
    const Stage st = stage_at(ring, p, s);
    Best top = kEmpty;
    int top_k = 0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int k = lane + 32 * q;
      if (c[q] >= 0) {
        st.cand[k] = c[q];
        st.cs[k] = sc[q];
        const float* src = p.free0 + static_cast<size_t>(c[q]) * p.R;
        float* dst = st.rows + k * MaxR;
        if (p.pairs) {
          for (int r = 0; r < p.R; r += 2) cp_async8(dst + r, src + r);
        } else {
          for (int r = 0; r < p.R; ++r) cp_async4(dst + r, src + r);
        }
        const Best b{score_key(sc[q]), noise_key(p.seed, i, c[q]),
                     static_cast<uint32_t>(c[q])};
        if (better(b, top)) {
          top = b;
          top_k = k;
        }
      }
    }
    if (lane < p.R)
      cp_async4(st.req + lane, p.requests + static_cast<size_t>(i) * p.R +
                                   lane);
    if (lane == 0) cp_async4(st.bound, p.kth + i);
    if (lane == 1) cp_async4(st.bound + 1, p.kth_noise + i);
    mbar_arrive_copies(&full[s]);
    const Best wt = warp_best(top);
    const int from = __ffs(__ballot_sync(kFull, top.col == wt.col)) - 1;
    top_k = __shfl_sync(kFull, top_k, from);
    if (lane == 0)
      *st.top = make_int4(static_cast<int>(wt.col), static_cast<int>(wt.skey),
                          static_cast<int>(wt.nkey), top_k);
    mbar_arrive(&full[s]);  // release: the stores above
    s += kProducerWarps;
    while (s >= p.stages) {
      s -= p.stages;
      ++round;
    }
  }
}

// The full-row pick for pod i by the walker and the helpers (every one of
// them calls it after kBarPost): each column's free row is its overlay
// row when present, else its free0 row. Returns the best, the same in
// every thread.
template <int MaxR, bool kSharedRows>
__device__ Best repair_pick(const Params& p,
                            const Overlay<MaxR, kSharedRows>& ov,
                            const float* req_s, Best* part, int i, int rtid,
                            int rwarp) {
  float req[MaxR];
  load_padded<MaxR>(req, req_s);
  const float* srow = p.scores + static_cast<size_t>(i) * p.N;
  Best t = kEmpty;
  float v0[MaxR], v1[MaxR];
  auto src = [&](int j) -> const float* {
    const int slot = ov.lookup(j);
    return slot >= 0 ? ov.row(j, slot) : p.free0 + static_cast<size_t>(j) * p.R;
  };
  auto consider = [&](const float (&v)[MaxR], int j, float s) {
    if (covers<MaxR>(v, req)) {
      const Best b{score_key(s), noise_key(p.seed, i, j),
                   static_cast<uint32_t>(j)};
      if (better(b, t)) t = b;
    }
  };
  for (int j = rtid; j < p.N; j += 2 * kRepairThreads) {
    const int j1 = j + kRepairThreads;
    load_row<MaxR>(v0, src(j), p.R);
    const float s0 = srow[j];
    float s1 = 0.f;
    if (j1 < p.N) {
      load_row<MaxR>(v1, src(j1), p.R);
      s1 = srow[j1];
    }
    consider(v0, j, s0);
    if (j1 < p.N) consider(v1, j1, s1);
  }
  const Best w = warp_best(t);
  if ((rtid & 31) == 0) part[rwarp] = w;
  bar_sync(kBarRepair, kRepairThreads);
  Best b = part[0];
  for (int k = 1; k < kRepairWarps; ++k)
    if (better(part[k], b)) b = part[k];
  return b;
}

// Block b's view of the launch: lane b's inputs and outputs and seed.
__device__ __forceinline__ Params lane_params(const Params& pb) {
  Params p = pb;
  const size_t t = blockIdx.x;
  const size_t pn = t * pb.P, nr = t * pb.N * pb.R;
  p.scores += pn * pb.N;
  p.cand += pn * pb.K;
  p.cand_scores += pn * pb.K;
  p.kth += pn;
  p.kth_noise += pn;
  p.requests += pn * pb.R;
  p.free0 += nr;
  p.free_after += nr;
  p.chosen += pn;
  p.assigned += pn;
  p.repaired += pn;
  if (pb.seeds != nullptr) p.seed = pb.seeds[t];
  return p;
}

// One block's walk over its batch (the kernel's body).
template <int MaxR, bool kSharedRows>
__device__ __forceinline__ void scan_block(const Params& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_full[kMaxStages];
  __shared__ uint64_t s_empty[kMaxStages];
  __shared__ Best s_part[kRepairWarps];
  __shared__ int s_post[2];  // the pod to repair (or -1: the end), its stage
  __shared__ int s_nslots;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float kInf = __int_as_float(0x7f800000);

  unsigned char* ring = smem;
  unsigned char* over =
      smem + static_cast<size_t>(p.stages) * p.stage_bytes;
  const int M = min(p.P, p.N);
  Overlay<MaxR, kSharedRows> ov;
  ov.bitmap = p.bitmap_words ? reinterpret_cast<uint32_t*>(over) : nullptr;
  ov.table = reinterpret_cast<int2*>(over + p.off_table);
  ov.mask = (1u << p.table_bits) - 1u;
  ov.shift = 32 - p.table_bits;
  ov.slot_col = reinterpret_cast<int32_t*>(
      over + p.off_table + (static_cast<size_t>(8) << p.table_bits));
  ov.rows = reinterpret_cast<float*>(ov.slot_col) + ((M + 3) & ~3);
  ov.nslots = &s_nslots;
  ov.free_after = p.free_after;
  ov.R = p.R;

  for (int h = tid; h < p.bitmap_words; h += kThreads) ov.bitmap[h] = 0u;
  if (kSharedRows) {
    for (int h = tid; h < (1 << p.table_bits); h += kThreads)
      ov.table[h] = make_int2(-1, -1);
  }
  // The ring's pads, which the producers never write.
  const int pad = MaxR - p.R;
  for (int x = tid; x < p.stages * (p.ring_k + 1) * pad; x += kThreads) {
    const int s = x / ((p.ring_k + 1) * pad);
    const int y = x - s * (p.ring_k + 1) * pad;
    const int k = y / pad, r = p.R + (y - k * pad);
    const Stage st = stage_at(ring, p, s);
    if (k < p.ring_k)
      st.rows[k * MaxR + r] = kInf;
    else
      st.req[r] = -kInf;
  }
  if (tid == 0) {
    s_nslots = 0;
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&s_full[s], 64);  // a producer warp's copies and stores
      mbar_init(&s_empty[s], 1);  // the walker
    }
  }
  __syncthreads();

  if (warp >= 1 && warp < kHelperWarp0) {
    produce<MaxR>(p, ring, s_full, s_empty, warp - 1);
    return;
  }
  // The walker (warp 0, rtid 0-31) and the helpers (rtid 32 on).
  const int rwarp = warp == 0 ? 0 : warp - kProducerWarps;
  const int rtid = rwarp * 32 + lane;
  if (warp == 0) {
    const uint32_t kneg = score_key(kNeg);
    float req[MaxR];
    int s = 0;
    uint32_t phase = 0;
    for (int i = 0; i < p.P; ++i) {
      mbar_wait(&s_full[s], phase);
      const Stage st = stage_at(ring, p, s);
      load_padded<MaxR>(req, st.req);
      const float kth_i = st.bound[0], kthn_i = st.bound[1];

      Best best = kEmpty;
      const float* bsrc = nullptr;  // the lane's best candidate's row
      bool bpad = true;
      int bslot = -1;
      float v[MaxR];
      // The best candidate first (every lane alike): when it fits, it is
      // the winner among the fitting ones.
      bool top_fits = false;
      if (p.K == p.ring_k) {
        const int4 top = *st.top;
        bslot = ov.lookup(top.x);
        bsrc = bslot >= 0 ? ov.row(top.x, bslot) : st.rows + top.w * MaxR;
        bpad = bslot >= 0 ? kSharedRows : true;
        load_any<MaxR>(v, bsrc, bpad, p.R);
        top_fits = covers<MaxR>(v, req);
        if (top_fits)
          best = Best{static_cast<uint32_t>(top.y),
                      static_cast<uint32_t>(top.z),
                      static_cast<uint32_t>(top.x)};
      }
      if (!top_fits) {
        auto consider = [&](int c, float sc, int slot, const float* base,
                            bool base_padded) {
          const float* src = slot >= 0 ? ov.row(c, slot) : base;
          const bool padded = slot >= 0 ? kSharedRows : base_padded;
          float u[MaxR];
          load_any<MaxR>(u, src, padded, p.R);
          if (covers<MaxR>(u, req)) {
            const Best b{score_key(sc), noise_key(p.seed, i, c),
                         static_cast<uint32_t>(c)};
            if (better(b, best)) {
              best = b;
              bsrc = src;
              bpad = padded;
              bslot = slot;
            }
          }
        };
        // The ring's candidates in phases, so that the lane's four
        // columns' loads overlap: columns and scores, the bitmap, the
        // few slots.
        constexpr int kQ = kRingK / 32;
        int cq[kQ], sl[kQ];
        float sq[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int k = lane + 32 * q;
          cq[q] = k < p.ring_k ? st.cand[k] : -1;
          sq[q] = k < p.ring_k ? st.cs[k] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) sl[q] = cq[q] >= 0 && ov.debited(cq[q]);
#pragma unroll
        for (int q = 0; q < kQ; ++q) sl[q] = sl[q] ? ov.slot_of(cq[q]) : -1;
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          if (cq[q] >= 0)
            consider(cq[q], sq[q], sl[q], st.rows + (lane + 32 * q) * MaxR,
                     true);
        for (int k = p.ring_k + lane; k < p.K; k += 32) {  // K > kRingK
          const size_t at = static_cast<size_t>(i) * p.K + k;
          const int c = p.cand[at];
          consider(c, p.cand_scores[at], ov.lookup(c),
                   p.free0 + static_cast<size_t>(c) * p.R, false);
        }
      }
      Best w = top_fits ? best : warp_best(best);
      bool ok = w.skey > kneg;
      bool certified = kth_i <= kNeg;
      if (ok && !certified) {
        const uint32_t kk = score_key(kth_i);
        const float wn = static_cast<float>(w.nkey) * (1.0f / 16777216.0f);
        certified = w.skey > kk || (w.skey == kk && wn > kthn_i);
      }
      if (certified) {
        if (ok && best.col == w.col && (!top_fits || lane == 0)) {
          if (!top_fits) load_any<MaxR>(v, bsrc, bpad, p.R);
          const int slot = bslot >= 0 ? bslot : ov.insert(w.col);
          debit<MaxR>(ov.row(w.col, slot), kSharedRows, v, req, p.R);
        }
      } else {
        if (lane == 0) {
          s_post[0] = i;
          s_post[1] = s;
        }
        __syncwarp();
        bar_sync(kBarPost, kRepairThreads);
        w = repair_pick<MaxR, kSharedRows>(p, ov, st.req, s_part, i, rtid,
                                           rwarp);
        ok = w.skey > kneg;
        if (ok && lane == 0) {
          const int c = w.col;
          int slot = ov.lookup(c);
          const float* src = slot >= 0 ? ov.row(c, slot)
                                       : p.free0 + static_cast<size_t>(c) * p.R;
          load_any<MaxR>(v, src, slot >= 0 && kSharedRows, p.R);
          if (slot < 0) slot = ov.insert(c);
          debit<MaxR>(ov.row(c, slot), kSharedRows, v, req, p.R);
        }
      }
      __syncwarp();
      if (lane == 0) {
        p.chosen[i] = ok ? static_cast<int32_t>(w.col) : -1;
        p.assigned[i] = ok;
        p.repaired[i] = !certified;
        mbar_arrive(&s_empty[s]);
      }
      if (++s == p.stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    if (lane == 0) s_post[0] = -1;
    __syncwarp();
    bar_sync(kBarPost, kRepairThreads);
  } else {
    while (true) {
      bar_sync(kBarPost, kRepairThreads);
      const int i = s_post[0];
      if (i < 0) break;
      repair_pick<MaxR, kSharedRows>(p, ov, stage_at(ring, p, s_post[1]).req,
                                     s_part, i, rtid, rwarp);
    }
  }
  // The overlay rows into free_after (the device layout wrote them there).
  if (kSharedRows) {
    const int n = s_nslots;
    for (int x = rtid; x < n * p.R; x += kRepairThreads) {
      const int slot = x / p.R, r = x - slot * p.R;
      p.free_after[static_cast<size_t>(ov.slot_col[slot]) * p.R + r] =
          ov.rows[slot * MaxR + r];
    }
  }
}

// kLanes: the lane form (one block a lane, block b on lane b's slices and
// seed); else the one-batch launch, which reads its parameters as given
// (no per-block copy: the walker warp's registers stay as they were).
template <int MaxR, bool kSharedRows, bool kLanes>
__global__ void __launch_bounds__(kThreads, 1)
    shortlist_scan_kernel(const Params pb) {
  if constexpr (kLanes) {
    const Params p = lane_params(pb);
    scan_block<MaxR, kSharedRows>(p);
  } else {
    scan_block<MaxR, kSharedRows>(pb);
  }
}

template <int MaxR, bool kSharedRows, bool kLanes>
cudaError_t launch_as(const Params& p, int T, size_t dyn, cudaStream_t st) {
  auto kernel = shortlist_scan_kernel<MaxR, kSharedRows, kLanes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  kernel<<<T, kThreads, dyn, st>>>(p);
  return cudaGetLastError();
}

template <int MaxR, bool kSharedRows>
cudaError_t launch(const Params& p, int T, size_t dyn, cudaStream_t st) {
  return p.seeds != nullptr
             ? launch_as<MaxR, kSharedRows, true>(p, T, dyn, st)
             : launch_as<MaxR, kSharedRows, false>(p, T, dyn, st);
}

}  // namespace

// seeds: null (one lane, the scalar seed) or T u32 seeds in device memory.
// Every array leads with the lane axis: scores (T,P,N), free0 (T,N,R), ...
extern "C" int shortlist_scan_launch(const float* scores, const int32_t* cand,
                                     const float* cand_scores, const float* kth,
                                     const float* kth_noise,
                                     const float* requests, const float* free0,
                                     const uint32_t* seeds, uint32_t seed,
                                     int T, int P, int N, int K, int R,
                                     int32_t* chosen, uint8_t* assigned,
                                     float* free_after, uint8_t* repaired,
                                     void* stream) {
  if (T < 1 || N < 1 || P < 0 || K < 1 || K > N || R < 1 || R > kMaxR ||
      (seeds == nullptr && T != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(
      free_after, free0, sizeof(float) * static_cast<size_t>(T) * N * R,
      cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  if (P == 0) return kNoLaunch;

  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr,
                              shortlist_scan_kernel<kMaxR, false, true>);
  if (err != cudaSuccess) return err;
  const size_t budget = static_cast<size_t>(optin) - attr.sharedSizeBytes;

  Params p{scores, cand, cand_scores, kth, kth_noise, requests, free0,
           free_after, chosen, assigned, repaired, seeds, seed, P, N, K, R};
  const int rs = R <= 16 ? 16 : kMaxR;  // the build's MaxR: padded rows
  auto up16 = [](size_t x) { return (x + 15) & ~static_cast<size_t>(15); };
  p.ring_k = K < kRingK ? K : kRingK;
  p.pairs = R % 2 == 0 && (reinterpret_cast<uintptr_t>(free0) & 7) == 0;
  p.off_cs = static_cast<int>(up16(p.ring_k * 4));
  p.off_req = static_cast<int>(up16(p.off_cs + p.ring_k * 4));
  p.off_bound = p.off_req + rs * 4;
  p.off_top = static_cast<int>(up16(p.off_bound + 8));
  p.off_rows = p.off_top + 16;
  p.stage_bytes = p.off_rows + p.ring_k * rs * 4;
  const size_t M = static_cast<size_t>(P < N ? P : N);
  int bits = 6;
  while ((static_cast<size_t>(1) << bits) < 4 * M) ++bits;
  const size_t bitmap = up16((static_cast<size_t>(N) + 31) / 32 * 4);
  const size_t shared_rows = bitmap + (static_cast<size_t>(8) << bits) +
                             up16(M * 4) + M * rs * 4;
  const size_t stage = static_cast<size_t>(p.stage_bytes);
  // The shared layout with the deepest ring that fits, else the device
  // layout (with its bitmap when it fits beside two stages).
  const bool in_shared = shared_rows + 2 * stage <= budget;
  size_t over;
  if (in_shared) {
    over = shared_rows;
    p.bitmap_words = static_cast<int>(bitmap / 4);
    p.off_table = static_cast<int>(bitmap);
    p.table_bits = bits;
  } else {
    over = bitmap + 2 * stage <= budget ? bitmap : 0;
    p.bitmap_words = static_cast<int>(over / 4);
  }
  p.stages = static_cast<int>((budget - over) / stage);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  const size_t dyn = p.stages * stage + over;
  if (R <= 16)
    return in_shared ? launch<16, true>(p, T, dyn, st)
                     : launch<16, false>(p, T, dyn, st);
  return in_shared ? launch<kMaxR, true>(p, T, dyn, st)
                   : launch<kMaxR, false>(p, T, dyn, st);
}

extern "C" const char* shortlist_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
