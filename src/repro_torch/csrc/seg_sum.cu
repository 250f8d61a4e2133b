// seg_sum: out[b, f, s] = sum_k vals[b, f, k] * (seg[b, k] == s)
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_sum.py
// (seg_sum_pallas / _seg_sum_kernel).  The TPU kernel kept the (F, S)
// accumulator in VMEM while K streamed through in 128-wide tiles, reducing a
// (tile, S) one-hot per step.  On Hopper the one-hot would waste S-fold work,
// so each event scatters straight into its bucket with an int32 atomicAdd.
// Integer addition is associative and commutative, so the result is
// bit-exact whatever order the atomics land in.
//
// What bounds it: at the engine's shapes (K <= 512 events, F <= 5 fields,
// S <= (R+1)(NC+1) buckets) it moves a few KB, so one launch is bound by
// launch latency, not by bytes or atomics.  Design: one block per row with
// the (F, S) accumulator in shared memory when it fits (227 KB), zeroed,
// filled by a grid-stride loop over events, then written out once; ids
// outside [0, S) are skipped.  When F*S does not fit, a zeroing pass and a
// global-atomic pass over a (rows, event-blocks) grid take its place.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxShared = 227 * 1024;

__global__ void seg_sum_shared(const int32_t* __restrict__ seg,
                               const int32_t* __restrict__ vals,
                               int32_t* __restrict__ out, int F, int K, int S) {
  extern __shared__ int32_t acc[];  // (F, S)
  const int64_t row = blockIdx.x;
  const int32_t* seg_r = seg + row * K;
  const int32_t* vals_r = vals + row * F * K;
  int32_t* out_r = out + row * F * S;
  const int fs = F * S;
  for (int i = threadIdx.x; i < fs; i += blockDim.x) acc[i] = 0;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int s = seg_r[k];
    if (s < 0 || s >= S) continue;
    for (int f = 0; f < F; ++f) {
      const int32_t v = vals_r[static_cast<int64_t>(f) * K + k];
      if (v != 0) atomicAdd(&acc[f * S + s], v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < fs; i += blockDim.x) out_r[i] = acc[i];
}

__global__ void zero_i32(int32_t* __restrict__ p, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    p[i] = 0;
}

__global__ void seg_sum_global(const int32_t* __restrict__ seg,
                               const int32_t* __restrict__ vals,
                               int32_t* __restrict__ out, int F, int K, int S) {
  const int64_t row = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int s = seg[row * K + k];
  if (s < 0 || s >= S) return;
  for (int f = 0; f < F; ++f) {
    const int32_t v = vals[(row * F + f) * K + k];
    if (v != 0) atomicAdd(&out[(row * F + f) * S + s], v);
  }
}

}  // namespace

// seg (B, K) int32, vals (B, F, K) int32 -> out (B, F, S) int32, launched on
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int repro_seg_sum(const void* seg, const void* vals, void* out, int B,
                             int F, int K, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* seg_p = static_cast<const int32_t*>(seg);
  const auto* vals_p = static_cast<const int32_t*>(vals);
  auto* out_p = static_cast<int32_t*>(out);
  const size_t smem = static_cast<size_t>(F) * S * sizeof(int32_t);
  if (smem <= kMaxShared) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(seg_sum_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    seg_sum_shared<<<B, kThreads, smem, st>>>(seg_p, vals_p, out_p, F, K, S);
  } else {
    const int64_t n = static_cast<int64_t>(B) * F * S;
    zero_i32<<<1024, kThreads, 0, st>>>(out_p, n);
    const dim3 grid((K + kThreads - 1) / kThreads, B);
    if (K > 0) seg_sum_global<<<grid, kThreads, 0, st>>>(seg_p, vals_p, out_p, F, K, S);
  }
  return static_cast<int>(cudaGetLastError());
}
