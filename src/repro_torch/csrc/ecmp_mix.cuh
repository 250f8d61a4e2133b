// ecmp_mix.cuh: the ECMP port hash that ecmp_hash.cu and next_queue.cu
// share — mix32(flow*0x9E3779B1 ^ ev*0x85EBCA77 ^ salt*0xC2B2AE3D) % nports,
// with mix32 the murmur3 finalizer (constants 0x7FEB352D, 0x846CA68B).
//
// All in native uint32: wrapping is defined for unsigned types (unlike
// signed overflow), so the int32 inputs are reinterpreted, not converted by
// value, and the modulo is the unsigned one (nports >= 1, checked by the
// callers' wrappers).
#pragma once

#include <cstdint>

namespace ecmp_mix {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t port(int32_t flow, int32_t ev, int32_t salt,
                                         uint32_t nports) {
  const uint32_t x = static_cast<uint32_t>(flow) * 0x9E3779B1u ^
                     static_cast<uint32_t>(ev) * 0x85EBCA77u ^
                     static_cast<uint32_t>(salt) * 0xC2B2AE3Du;
  return mix32(x) % nports;
}

}  // namespace ecmp_mix
