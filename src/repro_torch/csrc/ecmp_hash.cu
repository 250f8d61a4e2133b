// ecmp_hash: out[i] = mix32(flow[i]*0x9E3779B1 ^ ev[i]*0x85EBCA77
//                           ^ salt[i]*0xC2B2AE3D) % nports[i]
// with mix32 the murmur3 finalizer (constants 0x7FEB352D, 0x846CA68B), all in
// wrapping uint32 arithmetic; the port a switch picks for each packet.
// nports is one count for every element, or one per element (a generated
// fabric's switches differ in their up-degree, the reference's
// TableTopology hashes with maximum(deg, 1) per arrival): then each thread
// reads its own lane, once, beside its three inputs, through the counts'
// row and column strides (0 along an axis they broadcast over, so a (K,)
// row of counts serves every row of (B, K) flows without a copy), and the
// launch is the same one.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ecmp_hash.py
// (ecmp_hash_pallas / _mix_kernel), which hashed (8, 128) int32 tiles of a
// lane-padded (R, 128) layout on the VPU.  That tiling is the TPU's; here
// the inputs are flat, with an optional leading row axis flattened into the
// element count, and the ragged end is masked by the thread index.
//
// What bounds it: 16 bytes per element (three int32 reads, one write) and
// about 15 integer operations (20 bytes with per-element port counts), so a
// large call is bound by bytes.  At the
// engine's shapes (K = MAX_ARR = 512 arrivals per tick) it moves 8 KB and is
// bound by launch latency.  Design: one thread per element, the hash of
// ecmp_mix.cuh (native uint32, one unsigned modulo by the runtime nports).
//
// The simulator's main path no longer launches this kernel: its hash sites
// are inside next_queue.cu's routing step, which includes the same header.
// This flat form stays the counterpart of ecmp_hash_pallas.
#include <cuda_runtime.h>
#include <cstdint>

#include "ecmp_mix.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void ecmp_hash_kernel(const int32_t* __restrict__ flow,
                                 const int32_t* __restrict__ ev,
                                 const int32_t* __restrict__ salt,
                                 const int32_t* __restrict__ nports_lane,
                                 int32_t* __restrict__ out, int64_t n, uint32_t nports,
                                 int64_t K, int64_t lane_row_stride, int64_t lane_col_stride) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t m =
      nports_lane == nullptr
          ? nports
          : static_cast<uint32_t>(
                nports_lane[(i / K) * lane_row_stride + (i % K) * lane_col_stride]);
  out[i] = static_cast<int32_t>(ecmp_mix::port(flow[i], ev[i], salt[i], m));
}

}  // namespace

// flow, ev, salt, out: n int32 each, rows of K (any row axis flattened),
// launched on `stream`.  nports_lane: int32 per-element port counts, element
// i at (i / K) * lane_row_stride + (i % K) * lane_col_stride, or null for the
// scalar nports; every count >= 1 (the wrapper checks the scalar; per-element
// counts are the caller's contract, as a count of 0 has no port).  Returns
// cudaGetLastError().
extern "C" int repro_ecmp_hash(const void* flow, const void* ev, const void* salt,
                               const void* nports_lane, void* out, long long n, int nports,
                               long long K, long long lane_row_stride,
                               long long lane_col_stride, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    ecmp_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(flow), static_cast<const int32_t*>(ev),
        static_cast<const int32_t*>(salt), static_cast<const int32_t*>(nports_lane),
        static_cast<int32_t*>(out), n, static_cast<uint32_t>(nports), K, lane_row_stride,
        lane_col_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
