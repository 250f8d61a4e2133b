// queue_tick: one switch tick — serve <= 1 packet per queue, then enqueue a
// batch of K arrivals with FIFO ranking against the running occupancy, tail
// drop at capacity and a RED mark ramp.
//
// Replaces the Pallas TPU kernel src/repro/kernels/queue_tick.py
// (queue_tick_pallas / _queue_tick_kernel).  That kernel streamed the
// arrivals through in 128-element tiles while a (1, Q) occupancy block
// stayed resident; each tile's insert positions are computed against the
// occupancy at the tile's start (initial lengths, minus service, plus the
// accepted arrivals of earlier tiles).  The tiling is part of the result —
// it decides `pos` of rejected arrivals (repro.kernels.ref.queue_tick_ref,
// tile=128) — so this kernel walks the same 128-element tiles in order.
//
// Design: one block of 128 threads per row, one arrival per thread per
// tile, the (Q,) occupancy in shared memory (a global scratch row when Q is
// too large).  A thread's rank among same-target arrivals of its tile is a
// count over the tile's earlier targets, staged in shared memory; after a
// barrier the accepted arrivals bump the occupancy with atomicAdd (order-
// free), and a second barrier closes the tile.  All four outputs match the
// reference, not only the ones the engine consumes.
//
// Floats: the RED ramp is (pos - kmin) / max(kmax - kmin, 1) with IEEE
// division (__fdiv_rn), as the reference computes it; the library is built
// without --use_fast_math, and the intrinsic pins the rounding regardless.
//
// What bounds it: K = 512 arrivals over Q = 384 queues move ~6 KB, so it is
// bound by launch latency; the serial per-tile rank count (<= 127 shared
// reads per thread) is small beside that.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 128;
constexpr size_t kMaxShared = 227 * 1024;

__global__ void queue_tick_kernel(const int32_t* __restrict__ target,
                                  const float* __restrict__ u,
                                  const int32_t* __restrict__ qlen,
                                  const uint8_t* __restrict__ serve, int K, int Q,
                                  int capacity, int kmin, int kmax,
                                  int32_t* __restrict__ o_qlen,
                                  uint8_t* __restrict__ o_accept,
                                  uint8_t* __restrict__ o_mark,
                                  int32_t* __restrict__ o_pos,
                                  int32_t* __restrict__ occ_global) {
  extern __shared__ int32_t occ_shared[];
  __shared__ int32_t tile_target[kTile];
  const int64_t row = blockIdx.x;
  const int32_t* target_r = target + row * K;
  const float* u_r = u + row * K;
  const int32_t* qlen_r = qlen + row * Q;
  const uint8_t* serve_r = serve != nullptr ? serve + row * Q : nullptr;
  int32_t* occ = occ_global != nullptr ? occ_global + row * Q : occ_shared;

  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const int32_t l = qlen_r[q];
    const bool served = serve_r != nullptr && l > 0 && serve_r[q] == 1;
    occ[q] = served ? l - 1 : l;
  }
  __syncthreads();

  const float span = fmaxf(__int2float_rn(kmax - kmin), 1.0f);
  for (int base = 0; base < K; base += kTile) {
    const int k = base + threadIdx.x;
    const int t = k < K ? target_r[k] : -1;
    tile_target[threadIdx.x] = t;
    __syncthreads();
    const bool real = k < K && t >= 0 && t < Q;
    int rank = 0;
    if (real) {
      for (int j = 0; j < static_cast<int>(threadIdx.x); ++j) rank += tile_target[j] == t;
    }
    const int pos = real ? occ[t] + rank : 0;
    const bool accept = real && pos < capacity;
    float ramp = __fdiv_rn(__int2float_rn(pos - kmin), span);
    ramp = fminf(fmaxf(ramp, 0.0f), 1.0f);
    const bool mark = accept && u_r[k] < ramp;
    __syncthreads();  // every read of this tile's occupancy is done
    if (accept) atomicAdd(&occ[t], 1);
    if (k < K) {
      o_accept[row * K + k] = accept ? 1 : 0;
      o_mark[row * K + k] = mark ? 1 : 0;
      o_pos[row * K + k] = pos;
    }
    __syncthreads();  // occupancy updated, tile_target free for the next tile
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x) o_qlen[row * Q + q] = occ[q];
}

}  // namespace

// target (B, K) int32 (ids outside [0, Q) are padding), u (B, K) float32,
// qlen (B, Q) int32, serve (B, Q) bool or null (serve nothing) ->
// new_qlen (B, Q) int32, accept/mark (B, K) bool, pos (B, K) int32.
// `scratch` is a (B, Q) int32 occupancy row, required only when Q ints
// exceed shared memory.
extern "C" int repro_queue_tick(const void* target, const void* u, const void* qlen,
                                const void* serve, int B, int K, int Q, int capacity,
                                int kmin, int kmax, void* o_qlen, void* o_accept,
                                void* o_mark, void* o_pos, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(Q) * sizeof(int32_t);
  int32_t* occ_global = nullptr;
  size_t dyn = smem;
  if (smem + kTile * sizeof(int32_t) > kMaxShared) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    occ_global = static_cast<int32_t*>(scratch);
    dyn = 0;
  } else if (smem > 48 * 1024 - kTile * sizeof(int32_t)) {
    cudaFuncSetAttribute(queue_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  queue_tick_kernel<<<B, kTile, dyn, st>>>(
      static_cast<const int32_t*>(target), static_cast<const float*>(u),
      static_cast<const int32_t*>(qlen), static_cast<const uint8_t*>(serve), K, Q, capacity,
      kmin, kmax, static_cast<int32_t*>(o_qlen), static_cast<uint8_t*>(o_accept),
      static_cast<uint8_t*>(o_mark), static_cast<int32_t*>(o_pos), occ_global);
  return static_cast<int>(cudaGetLastError());
}
