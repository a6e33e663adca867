// Host-port insertion into the device-resident used_ports, for Hopper.
//
// Replaces the sequential stage minisched_tpu/ops/residency.py
// _insert_ports (a lax.scan over pods, residency.py:195-224; not a Pallas
// kernel). Same function, bit for bit: for each pod in row order whose row
// is >= 0, each nonzero requested port, in slot order, lands in the first
// zero slot of the node's used_ports row; with no zero slot it is dropped
// (the host cache's overflow rule). Pure i32 writes, so the host replay
// (residency.replay_ports_host) into the engine's mirror matches it
// exactly, and the engine keeps this an independent device computation:
// uploading the host replay instead would make the mirror check vacuous.
//
// The chain without the chain. The ports written are never zero, so each
// insertion fills the next zero slot of the row as it was BEFORE the
// batch: a node's nonzero ports, taken in pod order then slot order, fill
// the original row's zero slots in order, and those past its last zero
// are dropped. A port's place is therefore its rank among its node's
// ports, which needs only the pod's prefix = the nonzero ports of the
// earlier pods on the same row. Every pod is independent then:
//
//   1. each thread takes one pod and sums the nonzero-port counts of the
//      earlier pods on its row, over tiles of (row, count) in shared
//      memory;
//   2. it walks its row's slots in the INPUT state (never written), counts
//      the zeros, and writes its ports into the zero slots of ranks
//      prefix, prefix + 1, ... of the output.
//
// Different pods write different slots, reads come only from the input,
// so no order is needed between threads or blocks; any PORT and any
// number of pods work (blocks of 256 pods).
//
// Bound. P*(1+PP)*4 bytes in and the state copied whole (read and write,
// 1.7 MB at 53248 x 8): about 1 us of HBM time. The prefix sums are
// O(P^2) compares in shared memory (0.5 M at P = 1024), a few microseconds
// at most; the launch and the copy set the time at the engine's shapes.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/shortlist_timing.py,
// PERF.md): 0.0062 ms of device time at the engine shape (113 pods in a
// bucket of 128, the copy included) and 0.0135 ms at 1,000 pods in a
// bucket of 1024, against 0.0995 and 0.761 ms for the one-warp chain it
// replaces, in turns.
//
// Interface: a plain C function that copies state into out on the caller's
// stream, launches on it, and returns the cudaError_t, or kNoLaunch (-1)
// when there was nothing to insert and only the copy ran. It allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // pods per block, and per shared tile
constexpr int kNoLaunch = -1;  // no cudaError_t is negative

__global__ void __launch_bounds__(kThreads)
    insert_ports_kernel(const int32_t* __restrict__ state,
                        int32_t* __restrict__ out,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ ports, int N, int P,
                        int PP, int PORT) {
  __shared__ int32_t s_row[kThreads];
  __shared__ int32_t s_cnt[kThreads];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int32_t r = i < P ? rows[i] : -1;
  const int32_t* pp = ports + static_cast<size_t>(i) * PP;

  // 1. The nonzero ports of the earlier pods on row r.
  int prefix = 0;
  const int last = min(P, (blockIdx.x + 1) * kThreads);
  for (int base = 0; base < last; base += kThreads) {
    const int j = base + tid;
    int32_t rj = -1, cj = 0;
    if (j < P) {
      rj = rows[j];
      for (int t = 0; t < PP; ++t)
        cj += ports[static_cast<size_t>(j) * PP + t] != 0;
    }
    __syncthreads();
    s_row[tid] = rj;
    s_cnt[tid] = cj;
    __syncthreads();
    const int m = min(kThreads, i - base);  // the tile's pods before i
    for (int q = 0; q < m; ++q) prefix += s_row[q] == r ? s_cnt[q] : 0;
  }
  if (r < 0 || r >= N) return;

  // 2. This pod's ports into the zero slots of ranks prefix, prefix+1, ...
  // of the row as it entered the batch; past its last zero they drop.
  const int32_t* src = state + static_cast<size_t>(r) * PORT;
  int32_t* dst = out + static_cast<size_t>(r) * PORT;
  int t = 0, zeros = 0;
  for (int s = 0; s < PORT; ++s) {
    if (src[s] != 0) continue;
    if (zeros++ < prefix) continue;
    while (t < PP && pp[t] == 0) ++t;
    if (t == PP) break;
    dst[s] = pp[t++];
  }
}

}  // namespace

extern "C" int insert_ports_launch(const int32_t* state, const int32_t* rows,
                                   const int32_t* ports, int N, int PORT,
                                   int P, int PP, int32_t* out, void* stream) {
  if (N < 0 || PORT < 1 || P < 0 || PP < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(out, state, sizeof(int32_t) * N * PORT,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  if (P == 0 || PP == 0 || N == 0) return kNoLaunch;
  insert_ports_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      state, out, rows, ports, N, P, PP, PORT);
  return cudaGetLastError();
}

extern "C" const char* insert_ports_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
