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
// Bound. The batch's port pods are few (the engine passes only pods that
// request ports, padded to a power of two): P*(1+PP)*4 bytes in, a few
// rows touched. The limit is the chain of dependent first-zero searches
// (a later port of the same node sees the earlier one's write), one warp
// ballot and one store each.
//
// Layout. One warp walks the pods in order; its lanes cover a row's slots
// (32 at a time), a ballot finds the first zero slot, lane 0 writes it,
// and __syncwarp orders the write before the next search.
//
// Interface: a plain C function that copies state into out on the caller's
// stream, launches on it, and returns the cudaError_t, or kNoLaunch (-1)
// when there was nothing to insert and only the copy ran. It allocates
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr int kNoLaunch = -1;  // no cudaError_t is negative

__global__ void __launch_bounds__(32, 1)
    insert_ports_kernel(int32_t* state, const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ ports, int P, int PP,
                        int PORT) {
  const int lane = threadIdx.x;
  for (int i = 0; i < P; ++i) {
    const int r = rows[i];
    if (r < 0) continue;
    int32_t* row = state + static_cast<size_t>(r) * PORT;
    for (int t = 0; t < PP; ++t) {
      const int32_t p = ports[static_cast<size_t>(i) * PP + t];
      if (p == 0) continue;
      int first = -1;
      for (int base = 0; base < PORT && first < 0; base += 32) {
        const int j = base + lane;
        const uint32_t empty = __ballot_sync(kFull, j < PORT && row[j] == 0);
        if (empty) first = base + __ffs(empty) - 1;
      }
      if (first >= 0 && lane == 0) row[first] = p;
      __syncwarp();
    }
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
  insert_ports_kernel<<<1, 32, 0, st>>>(out, rows, ports, P, PP, PORT);
  return cudaGetLastError();
}

extern "C" const char* insert_ports_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
