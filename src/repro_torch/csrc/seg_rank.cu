// seg_rank: rank[b, i] = #{j < i : seg[b, j] == seg[b, i]}, stable in input
// order; ids outside [0, S) rank 0.
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_rank.py
// (seg_rank_pallas / _seg_rank_kernel), which carried a (1, S) per-segment
// histogram in VMEM across 128-wide K tiles and ranked each tile with a
// cumulative sum over its (tile, S) one-hot.
//
// The rank has to stay stable in input order, so atomics alone (which land
// in any order) cannot compute it.  Design: one block per row walks K in
// tiles of blockDim (256) in order, keeping the running per-segment
// histogram in shared memory (in a global scratch row when S is too large).
// Inside a tile each warp finds equal ids among its lanes with
// __match_any_sync; an element's rank is the histogram count of its id,
// which already holds the tile's earlier warps, plus __popc(mask & lanes
// below me).  The warps then take turns: warp w reads, __syncwarp, its group
// leaders add their group sizes, __syncthreads, warp w+1.  So the histogram
// holds exactly the elements before the warp that reads it.
//
// What bounds it: at the engine's shapes (K = 128 ACK events, S = NC+1) it
// moves about 1 KB, so it is bound by launch latency; the per-tile warp
// turns cost 16 barriers per 256 elements, which is noise at this size.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // one tile = 8 warps
constexpr size_t kMaxShared = 227 * 1024;

__global__ void seg_rank_kernel(const int32_t* __restrict__ seg, int32_t* __restrict__ rank,
                                int32_t* __restrict__ hist_global, int K, int S) {
  extern __shared__ int32_t hist_shared[];
  const int64_t row = blockIdx.x;
  const int32_t* seg_r = seg + row * K;
  int32_t* rank_r = rank + row * K;
  int32_t* hist = hist_global != nullptr ? hist_global + row * S : hist_shared;
  for (int i = threadIdx.x; i < S; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < K; base += blockDim.x) {
    const int k = base + threadIdx.x;
    const int s = k < K ? seg_r[k] : -1;
    const bool valid = k < K && s >= 0 && s < S;
    // out-of-range lanes get a key no valid id (>= 0) or other lane shares
    const unsigned same = __match_any_sync(0xffffffffu, valid ? s : -1 - lane);
    const int in_warp = __popc(same & below);
    const bool leader = valid && (same & below) == 0u;
    int r = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (warp == w && valid) r = hist[s] + in_warp;
      __syncwarp();
      if (warp == w && leader) hist[s] += __popc(same);
      __syncthreads();
    }
    if (k < K) rank_r[k] = valid ? r : 0;
  }
}

}  // namespace

// seg (B, K) int32 -> rank (B, K) int32.  `scratch` is a (B, S) int32 global
// histogram, used (and required) only when S ints exceed shared memory.
extern "C" int repro_seg_rank(const void* seg, void* rank, void* scratch, int B, int K,
                              int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(S) * sizeof(int32_t);
  int32_t* hist_global = nullptr;
  size_t dyn = smem;
  if (smem > kMaxShared) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    hist_global = static_cast<int32_t*>(scratch);
    dyn = 0;
  } else if (smem > 48 * 1024) {
    cudaFuncSetAttribute(seg_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  seg_rank_kernel<<<B, kThreads, dyn, st>>>(static_cast<const int32_t*>(seg),
                                             static_cast<int32_t*>(rank), hist_global, K, S);
  return static_cast<int>(cudaGetLastError());
}
