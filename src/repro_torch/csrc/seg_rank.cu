// seg_rank: rank[b, i] = #{j < i : seg[b, j] == seg[b, i]}, stable in input
// order; ids outside [0, S) rank 0.
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_rank.py
// (seg_rank_pallas / _seg_rank_kernel), which carried a (1, S) per-segment
// histogram in VMEM across 128-wide K tiles and ranked each tile with a
// cumulative sum over its (tile, S) one-hot.
//
// What bounds it: at the engine's shape (K = 128 ACK events, S = NC + 1 =
// 129) it moves about 1 KB, so a launch is bound by its latency: the
// barriers and the shared-memory round trips between loading the ids and
// storing the ranks.  The design keeps that chain short.  One block per row
// holds one element per thread (the next multiple of 32 >= K, at most 1024
// threads: 4 warps at the engine's shape) and ranks them with
// stable_rank.cuh's per-warp count table (warps x S ints in shared memory):
// each thread loads its id before the table is zeroed, then one barrier after
// the zeroing and one after the group leaders' writes, and the rank is the
// in-warp rank plus the counts of the earlier warps.  K beyond one block
// loops over passes of blockDim elements with a running per-segment histogram
// (the last element of each segment in a pass stores the running count, after
// a third barrier).  When the table does not fit in shared memory (large S)
// the warps take turns instead on a running histogram in shared memory, or in
// a (B, S) global scratch row when S ints exceed shared memory.
#include <cuda_runtime.h>
#include <cstdint>

#include "stable_rank.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTurnThreads = 256;  // the warp-turn path's tile = 8 warps
constexpr size_t kMaxShared = 227 * 1024;

using stable_rank::WarpRank;

__global__ void __launch_bounds__(kMaxThreads)
    seg_rank_table(const int32_t* __restrict__ seg, int32_t* __restrict__ rank, int K, int S) {
  extern __shared__ int4 smem4[];
  int32_t* cnt = reinterpret_cast<int32_t*>(smem4);  // (warps, S)
  const int n_warps = blockDim.x >> 5;
  const bool multi = K > static_cast<int>(blockDim.x);
  int32_t* hist = cnt + stable_rank::table_ints(n_warps, S);  // (S,), multi-pass only
  const int64_t row = blockIdx.x;
  const int32_t* seg_r = seg + row * K;
  int32_t* rank_r = rank + row * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int k = threadIdx.x;
  int s = k < K ? seg_r[k] : -1;  // loaded before the zeroing, which hides its latency
  stable_rank::table_zero(cnt, n_warps * S);
  if (multi) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) hist[i] = 0;
  }
  __syncthreads();
  for (int base = 0; base < K; base += blockDim.x) {
    const bool valid = k < K && s >= 0 && s < S;
    const WarpRank wr = stable_rank::warp_rank(valid, s);
    stable_rank::table_publish(cnt, S, warp, s, wr);
    __syncthreads();
    int r = 0;
    bool last = false;  // the pass's last element of its segment
    if (valid) {
      r = wr.in_warp + stable_rank::table_sum(cnt, S, 0, warp, s);
      if (multi) {
        r += hist[s];
        last = (wr.same >> lane) == 1u && stable_rank::table_sum(cnt, S, warp + 1, n_warps, s) == 0;
      }
    }
    if (k < K) rank_r[k] = r;
    if (multi) {
      __syncthreads();  // every read of the histogram and the table is done
      if (last) hist[s] = r + 1;
      stable_rank::table_clear(cnt, S, warp, s, wr);
    }
    k += blockDim.x;
    s = k < K ? seg_r[k] : -1;
  }
}

// Warp turns on a running histogram: warp w reads, then its leaders add their
// group sizes, a barrier, then warp w + 1; so the histogram holds exactly the
// elements before the warp that reads it.  Only the entries of the row's own
// ids are read, so only those are cleared first: O(K) stores, not O(S) (the
// scale mode's S = NC + 1 = 10**6 + 1 took one block ~75 us to clear).
__global__ void seg_rank_turns(const int32_t* __restrict__ seg, int32_t* __restrict__ rank,
                               int32_t* __restrict__ hist_global, int K, int S) {
  extern __shared__ int32_t hist_shared[];
  const int64_t row = blockIdx.x;
  const int32_t* seg_r = seg + row * K;
  int32_t* rank_r = rank + row * K;
  int32_t* hist = hist_global != nullptr ? hist_global + row * S : hist_shared;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int s = seg_r[k];
    if (s >= 0 && s < S) hist[s] = 0;  // repeated ids store the same 0
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int base = 0; base < K; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int s = k < K ? seg_r[k] : -1;
    const bool valid = k < K && s >= 0 && s < S;
    const WarpRank wr = stable_rank::warp_rank(valid, s);
    int r = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (warp == w && valid) r = hist[s] + wr.in_warp;
      __syncwarp();
      if (warp == w && wr.leader) hist[s] += __popc(wr.same);
      __syncthreads();
    }
    if (k < K) rank_r[k] = r;
  }
}

}  // namespace

// seg (B, K) int32 -> rank (B, K) int32.  `scratch` is a (B, S) int32 global
// histogram, used (and required) only when S ints exceed shared memory.
extern "C" int repro_seg_rank(const void* seg, void* rank, void* scratch, int B, int K,
                              int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || K == 0) return static_cast<int>(cudaGetLastError());
  const auto* seg_p = static_cast<const int32_t*>(seg);
  auto* rank_p = static_cast<int32_t*>(rank);
  const int threads = K >= kMaxThreads ? kMaxThreads : (K + 31) / 32 * 32;
  const bool multi = K > threads;
  const size_t table =
      (stable_rank::table_ints(threads / 32, S) + (multi ? S : 0)) * sizeof(int32_t);
  if (table <= kMaxShared) {
    if (table > 48 * 1024) {
      cudaFuncSetAttribute(seg_rank_table, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(table));
    }
    seg_rank_table<<<B, threads, table, st>>>(seg_p, rank_p, K, S);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t hist = static_cast<size_t>(S) * sizeof(int32_t);
  int32_t* hist_global = nullptr;
  size_t dyn = hist;
  if (hist > kMaxShared) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    hist_global = static_cast<int32_t*>(scratch);
    dyn = 0;
  } else if (hist > 48 * 1024) {
    cudaFuncSetAttribute(seg_rank_turns, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(hist));
  }
  seg_rank_turns<<<B, kTurnThreads, dyn, st>>>(seg_p, rank_p, hist_global, K, S);
  return static_cast<int>(cudaGetLastError());
}
