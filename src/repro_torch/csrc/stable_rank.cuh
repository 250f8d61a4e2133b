// stable_rank.cuh: the FIFO rank #{j < i : key_j == key_i}, stable in input
// order, of the elements of one block pass — the primitive that seg_rank.cu
// and queue_tick.cu share.
//
// Inside a warp, __match_any_sync finds the lanes that hold the same key and
// __popc(mask & lanes below) is the rank among them.  Across the warps of a
// pass a per-warp count table cnt[w * n_keys + key] in shared (or global
// scratch) memory takes the place of warps taking turns: each group's leader
// (its lowest lane; a key has exactly one leader per warp) writes the group's
// size, and after one barrier an element's rank is its in-warp rank plus the
// counts of the earlier warps of its group.  One writer per entry, so no
// atomics: atomics land in any order and could not give a stable rank.
//
// The table starts zeroed (table_zero, then a barrier); after a pass each
// leader clears its own entry (table_clear), and the next pass's leaders
// write theirs after a __syncwarp, so a multi-pass caller zeroes it once.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace stable_rank {

struct WarpRank {
  unsigned same;  // lanes of this warp that hold this lane's key
  int in_warp;    // rank among them: lanes below this one
  bool leader;    // lowest such lane of a valid key
};

// Every lane of the warp must call this.  Lanes with valid == false get a key
// no valid key (>= 0) or other lane shares, and rank 0.
__device__ __forceinline__ WarpRank warp_rank(bool valid, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  WarpRank r;
  r.same = __match_any_sync(0xffffffffu, valid ? key : -1 - lane);
  r.in_warp = __popc(r.same & below);
  r.leader = valid && (r.same & below) == 0u;
  return r;
}

// Zero `n` ints of a 16-byte aligned table, padded to whole int4s, with every
// thread of the block; a barrier must follow before any leader writes.
__device__ __forceinline__ void table_zero(int32_t* table, int n) {
  int4* t4 = reinterpret_cast<int4*>(table);
  for (int i = threadIdx.x; i < (n + 3) / 4; i += blockDim.x) t4[i] = make_int4(0, 0, 0, 0);
}

// The leader of each group writes its size into row `warp`; a barrier must
// follow before anyone reads the table.  The __syncwarp orders this write
// after the previous pass's table_clear by another lane of the same warp.
__device__ __forceinline__ void table_publish(int32_t* table, int n_keys, int warp, int key,
                                              const WarpRank& r) {
  __syncwarp();
  if (r.leader) table[warp * n_keys + key] = __popc(r.same);
}

// Sum of the counts of `key` in warps [w_lo, w_hi).
__device__ __forceinline__ int table_sum(const int32_t* table, int n_keys, int w_lo, int w_hi,
                                         int key) {
  int s = 0;
#pragma unroll 4
  for (int w = w_lo; w < w_hi; ++w) s += table[w * n_keys + key];  // loads issued 4 at a time
  return s;
}

// Undo table_publish once every read of this pass is behind a barrier.
__device__ __forceinline__ void table_clear(int32_t* table, int n_keys, int warp, int key,
                                            const WarpRank& r) {
  if (r.leader) table[warp * n_keys + key] = 0;
}

// Ints of a table of `warps` rows of `n_keys`, padded to whole int4s.
__host__ __device__ __forceinline__ size_t table_ints(int warps, int n_keys) {
  return (static_cast<size_t>(warps) * n_keys + 3) / 4 * 4;
}

}  // namespace stable_rank
