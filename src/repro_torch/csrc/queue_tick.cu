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
// tile=128) — and this kernel reproduces it exactly.
//
// What bounds it: K = 512 arrivals over Q = 384 queues move ~10 KB, so a
// launch is bound by its latency: the chain of barriers and shared-memory
// round trips between loading the arrivals and storing the results.  The
// design takes every arrival in one pass instead of walking the tiles in
// order.  One block per row holds one arrival per thread (the next multiple
// of 32 >= K, at most 1024 threads; K beyond that loops over passes of whole
// tiles), a tile being 4 warps.  stable_rank.cuh's per-warp count table
// (warps x Q ints) gives each arrival its rank among same-queue arrivals of
// its tile and each tile's per-queue count cnt_t[q].  The tile-to-tile
// occupancy carry then has a closed form, since the arrivals of tile t for q
// have ranks 0 ... cnt_t[q] - 1 and exactly those with occ_t[q] + rank < cap
// are accepted:
//     occ_{t+1}[q] = occ_t[q] + clamp(cap - occ_t[q], 0, cnt_t[q]),
// which one thread per queue walks over the pass's <= 8 tiles; then
// pos = occ_t[target] + rank and accept = real && pos < cap.  Three barriers
// per pass (after the zeroing, after the leaders' writes, after the carry)
// where walking the tiles in order costs three per tile.  When
// the table, the tiles' occupancies and the running occupancy do not fit in
// shared memory, the block shrinks to one tile (128 threads); past that they
// live in a (B, work_ints) global scratch row.
//
// The arrivals stage's glue is optional inside the launch:
// - the RED mark.  By default it is the TPU kernel's own: the ramp
//   (pos - kmin) / max(kmax - kmin, 1) with IEEE division (__fdiv_rn).  With
//   engine_mark it is the simulator's: clamp((float(pos) - kmin) * red_rcp,
//   0, 1) * pmax, the float32 reciprocal multiply XLA makes of the
//   reference engine's division, every operation pinned with an _rn
//   intrinsic so that no FMA contraction changes the rounding;
// - the ring slot (q_head[target] + pos) mod qcap of every arrival, with
//   q_head read as 0 for targets outside [0, Q), when q_head is given; the
//   heads are staged in shared memory with the occupancy, so that no global
//   load waits on a target.
#include <cuda_runtime.h>
#include <cstdint>

#include "stable_rank.cuh"

namespace {

constexpr int kTile = 128;  // arrivals per TPU tile; part of the result
constexpr int kTileWarps = kTile / 32;
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxShared = 227 * 1024;

using stable_rank::WarpRank;

// Ints of a row's working memory: the (warps, Q) count table, then the
// (tiles, Q) occupancies at each tile's start, the (Q,) running occupancy
// and the (Q,) ring heads, padded to whole int4s.
__host__ __device__ size_t work_ints(int warps, int Q) {
  const int tiles = (warps + kTileWarps - 1) / kTileWarps;
  return stable_rank::table_ints(warps, Q) + (static_cast<size_t>(tiles + 2) * Q + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kMaxThreads)
    queue_tick_kernel(const int32_t* __restrict__ target, const float* __restrict__ u,
                      const int32_t* __restrict__ qlen, const uint8_t* __restrict__ serve,
                      const int32_t* __restrict__ q_head, int K, int Q, int capacity, int kmin,
                      int kmax, int engine_mark, float red_rcp, float pmax, int qcap,
                      int32_t* __restrict__ o_qlen, uint8_t* __restrict__ o_accept,
                      uint8_t* __restrict__ o_mark, int32_t* __restrict__ o_pos,
                      int32_t* __restrict__ o_slot, int32_t* __restrict__ work_global) {
  extern __shared__ int4 smem4[];
  const int n_warps = blockDim.x >> 5;
  const int n_tiles = (n_warps + kTileWarps - 1) / kTileWarps;
  const int64_t row = blockIdx.x;
  int32_t* cnt = work_global != nullptr ? work_global + row * work_ints(n_warps, Q)
                                        : reinterpret_cast<int32_t*>(smem4);  // (warps, Q)
  int32_t* tile_occ = cnt + stable_rank::table_ints(n_warps, Q);  // (tiles, Q)
  int32_t* occ = tile_occ + n_tiles * Q;                          // (Q,)
  int32_t* heads = occ + Q;  // (Q,): q_head staged, so no load waits on a target
  const int32_t* target_r = target + row * K;
  const float* u_r = u + row * K;
  const int32_t* qlen_r = qlen + row * Q;
  const uint8_t* serve_r = serve != nullptr ? serve + row * Q : nullptr;
  const int32_t* q_head_r = q_head != nullptr ? q_head + row * Q : nullptr;
  const int warp = threadIdx.x >> 5;
  const int tile = warp / kTileWarps;
  const float span = fmaxf(__int2float_rn(kmax - kmin), 1.0f);

  // this thread's arrival, loaded before the zeroing, which hides its latency
  int k = threadIdx.x;
  int t = k < K ? target_r[k] : -1;
  float uk = k < K ? u_r[k] : 0.0f;
  stable_rank::table_zero(cnt, n_warps * Q);
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const int32_t l = qlen_r[q];
    occ[q] = serve_r != nullptr && l > 0 && serve_r[q] == 1 ? l - 1 : l;
    if (q_head_r != nullptr) heads[q] = q_head_r[q];
  }
  __syncthreads();

  for (int base = 0; base < K; base += blockDim.x) {
    const bool real = k < K && t >= 0 && t < Q;
    const WarpRank wr = stable_rank::warp_rank(real, t);
    stable_rank::table_publish(cnt, Q, warp, t, wr);
    __syncthreads();
    const int rank =
        real ? wr.in_warp + stable_rank::table_sum(cnt, Q, tile * kTileWarps, warp, t) : 0;
    // the carry: queue q's occupancy at the start of each tile of this pass
    for (int q = threadIdx.x; q < Q; q += blockDim.x) {
      int o = occ[q];
      for (int g = 0; g < n_tiles; ++g) {
        tile_occ[g * Q + q] = o;
        const int c = stable_rank::table_sum(cnt, Q, g * kTileWarps,
                                             min((g + 1) * kTileWarps, n_warps), q);
        o += min(max(capacity - o, 0), c);
      }
      occ[q] = o;
    }
    __syncthreads();
    if (k < K) {
      const int pos = real ? tile_occ[tile * Q + t] + rank : 0;
      const bool accept = real && pos < capacity;
      float ramp;
      if (engine_mark) {
        ramp = __fmul_rn(__fsub_rn(__int2float_rn(pos), __int2float_rn(kmin)), red_rcp);
        ramp = __fmul_rn(fminf(fmaxf(ramp, 0.0f), 1.0f), pmax);
      } else {
        ramp = fminf(fmaxf(__fdiv_rn(__int2float_rn(pos - kmin), span), 0.0f), 1.0f);
      }
      const int64_t i = row * K + k;
      o_accept[i] = accept ? 1 : 0;
      o_mark[i] = accept && uk < ramp ? 1 : 0;
      o_pos[i] = pos;
      if (o_slot != nullptr) {
        const int v = ((real ? heads[t] : 0) + pos) % qcap;
        o_slot[i] = v < 0 ? v + qcap : v;  // floor modulo, as the plain version's %
      }
    }
    if (base + static_cast<int>(blockDim.x) < K) stable_rank::table_clear(cnt, Q, warp, t, wr);
    k += blockDim.x;
    t = k < K ? target_r[k] : -1;
    uk = k < K ? u_r[k] : 0.0f;
  }
  for (int q = threadIdx.x; q < Q; q += blockDim.x) o_qlen[row * Q + q] = occ[q];
}

}  // namespace

// Ints of the global working row that repro_queue_tick needs per row of the
// batch when Q is too large for shared memory (0 when it is not): the
// wrapper allocates B times this as `scratch`.
extern "C" long long repro_queue_tick_scratch_ints(int Q) {
  const size_t one_tile = work_ints(kTileWarps, Q);
  return one_tile * sizeof(int32_t) > kMaxShared ? static_cast<long long>(one_tile) : 0;
}

// target (B, K) int32 (ids outside [0, Q) are padding), u (B, K) float32,
// qlen (B, Q) int32, serve (B, Q) bool or null (serve nothing), q_head (B, Q)
// int32 or null -> new_qlen (B, Q) int32, accept/mark (B, K) bool, pos (B, K)
// int32 and, when q_head is given, slot (B, K) int32.  engine_mark selects the
// engine's RED mark (red_rcp, pmax) over the TPU kernel's division.
// `scratch` is B x repro_queue_tick_scratch_ints(Q) ints, required only when
// that is not 0.
extern "C" int repro_queue_tick(const void* target, const void* u, const void* qlen,
                                const void* serve, const void* q_head, int B, int K, int Q,
                                int capacity, int kmin, int kmax, int engine_mark,
                                float red_rcp, float pmax, int qcap, void* o_qlen,
                                void* o_accept, void* o_mark, void* o_pos, void* o_slot,
                                void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  if (q_head != nullptr && qcap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int threads = K >= kMaxThreads ? kMaxThreads : max(32, (K + 31) / 32 * 32);
  size_t smem = work_ints(threads / 32, Q) * sizeof(int32_t);
  int32_t* work_global = nullptr;
  if (smem > kMaxShared) {
    threads = min(threads, kTile);  // one tile per pass
    smem = work_ints(threads / 32, Q) * sizeof(int32_t);
  }
  if (smem > kMaxShared) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    threads = kTile;  // the row stride repro_queue_tick_scratch_ints assumes
    work_global = static_cast<int32_t*>(scratch);
    smem = 0;
  } else if (smem > 48 * 1024) {
    cudaFuncSetAttribute(queue_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  queue_tick_kernel<<<B, threads, smem, st>>>(
      static_cast<const int32_t*>(target), static_cast<const float*>(u),
      static_cast<const int32_t*>(qlen), static_cast<const uint8_t*>(serve),
      static_cast<const int32_t*>(q_head), K, Q, capacity, kmin, kmax, engine_mark, red_rcp,
      pmax, qcap, static_cast<int32_t*>(o_qlen), static_cast<uint8_t*>(o_accept),
      static_cast<uint8_t*>(o_mark), static_cast<int32_t*>(o_pos), static_cast<int32_t*>(o_slot),
      work_global);
  return static_cast<int>(cudaGetLastError());
}
