// ecmp_hash: out[i] = mix32(flow[i]*0x9E3779B1 ^ ev[i]*0x85EBCA77
//                           ^ salt[i]*0xC2B2AE3D) % nports
// with mix32 the murmur3 finalizer (constants 0x7FEB352D, 0x846CA68B), all in
// wrapping uint32 arithmetic; the port a switch picks for each packet.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ecmp_hash.py
// (ecmp_hash_pallas / _mix_kernel), which hashed (8, 128) int32 tiles of a
// lane-padded (R, 128) layout on the VPU.  That tiling is the TPU's; here
// the inputs are flat, with an optional leading row axis flattened into the
// element count, and the ragged end is masked by the thread index.
//
// What bounds it: 16 bytes per element (three int32 reads, one write) and
// about 15 integer operations, so a large call is bound by bytes.  At the
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
                                 int32_t* __restrict__ out, int64_t n, uint32_t nports) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  out[i] = static_cast<int32_t>(ecmp_mix::port(flow[i], ev[i], salt[i], nports));
}

}  // namespace

// flow, ev, salt, out: n int32 each (any row axis flattened), launched on
// `stream`; nports >= 1 (the wrapper checks).  Returns cudaGetLastError().
extern "C" int repro_ecmp_hash(const void* flow, const void* ev, const void* salt, void* out,
                               long long n, int nports, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    ecmp_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(flow), static_cast<const int32_t*>(ev),
        static_cast<const int32_t*>(salt), static_cast<int32_t*>(out), n,
        static_cast<uint32_t>(nports));
  }
  return static_cast<int>(cudaGetLastError());
}
