// seg_sum: out[b, f, s] = sum_k vals_f[b, k] * (seg[b, k] == s)
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_sum.py
// (seg_sum_pallas / _seg_sum_kernel).  The TPU kernel kept the (F, S)
// accumulator in VMEM while K streamed through in 128-wide tiles, reducing a
// (tile, S) one-hot per step.  On Hopper the one-hot would waste S-fold work,
// so each event scatters straight into its bucket with an int32 atomicAdd.
// Integer addition is associative and commutative, so the result is
// bit-exact whatever order the atomics land in.
//
// What bounds it: at the engine's shapes (K <= 512 events, F <= 7 fields,
// S <= (R+1)(NC+1) buckets) it moves a few KB, so a launch is bound by
// launch latency and by the host work around it, not by bytes or atomics.
// The design takes that host work away: the F <= 8 fields arrive as they
// are, each its own (B, K) bool or int32 array (or rows of one stacked
// (B, F, K) int32 array), their pointers and type flags passed by value in
// the launch's parameters, so the caller neither stacks nor casts them.  One
// block per row holds the (F, S) accumulator in shared memory when it fits
// (227 KB).  The block has the next multiple of 32 threads >= K (at most
// 1024), so at the engine's shapes each thread holds one event: it loads its
// segment id and field values into registers before the accumulator is
// zeroed, so the loads' latency overlaps the zeroing; values of 0 are not
// added.  The row is written out with 16-byte stores (scalar stores only at
// an unaligned head and tail).  Ids outside [0, S) are skipped.  When F*S
// does not fit, a zeroing pass and a global-atomic pass over a (rows,
// event-blocks) grid take its place.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxFields = 8;
constexpr int kMaxThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr size_t kMaxShared = 227 * 1024;

struct Fields {
  const void* ptr[kMaxFields];  // field f of row b, event k: ptr[f] + b * row_stride + k
  unsigned is_bool;             // bit f set: field f holds one byte per event
  int n;                        // F
  long long row_stride;         // in events
};

__device__ __forceinline__ int32_t field_at(const Fields& fs, int f, int64_t idx) {
  return (fs.is_bool >> f) & 1u
             ? static_cast<int32_t>(static_cast<const uint8_t*>(fs.ptr[f])[idx])
             : static_cast<const int32_t*>(fs.ptr[f])[idx];
}

__global__ void __launch_bounds__(kMaxThreads)
    seg_sum_shared(const int32_t* __restrict__ seg, const Fields fs, int32_t* __restrict__ out,
                   int K, int S) {
  extern __shared__ int4 acc4[];  // (F, S), padded to whole int4s
  int32_t* acc = reinterpret_cast<int32_t*>(acc4);
  const int64_t row = blockIdx.x;
  const int F = fs.n;
  const int fs_n = F * S;
  const int64_t base = row * fs.row_stride;
  const int32_t* seg_r = seg + row * K;

  // this thread's first event, loaded before the accumulator is zeroed
  int k = threadIdx.x;
  int s = -1;
  int32_t v[kMaxFields];
  if (k < K) {
    s = seg_r[k];
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) v[f] = f < F ? field_at(fs, f, base + k) : 0;
  }
  const int n4 = (fs_n + 3) / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) acc4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  while (k < K) {
    if (s >= 0 && s < S) {
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f)
        if (f < F && v[f] != 0) atomicAdd(&acc[f * S + s], v[f]);
    }
    k += blockDim.x;
    if (k < K) {
      s = seg_r[k];
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) v[f] = f < F ? field_at(fs, f, base + k) : 0;
    }
  }
  __syncthreads();

  int32_t* out_r = out + row * fs_n;
  const unsigned misalign = static_cast<unsigned>(reinterpret_cast<uintptr_t>(out_r) & 15u);
  const int head = min(fs_n, static_cast<int>(((16u - misalign) & 15u) / 4u));
  const int body = (fs_n - head) / 4;
  for (int i = threadIdx.x; i < head; i += blockDim.x) out_r[i] = acc[i];
  int4* out4 = reinterpret_cast<int4*>(out_r + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) {
    const int j = head + 4 * i;
    out4[i] = make_int4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  }
  for (int i = head + 4 * body + threadIdx.x; i < fs_n; i += blockDim.x) out_r[i] = acc[i];
}

__global__ void zero_i32(int32_t* __restrict__ p, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    p[i] = 0;
}

__global__ void seg_sum_global(const int32_t* __restrict__ seg, const Fields fs,
                               int32_t* __restrict__ out, int K, int S) {
  const int64_t row = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int s = seg[row * K + k];
  if (s < 0 || s >= S) return;
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    if (f >= fs.n) break;
    const int32_t v = field_at(fs, f, row * fs.row_stride + k);
    if (v != 0) atomicAdd(&out[(row * fs.n + f) * S + s], v);
  }
}

}  // namespace

// seg (B, K) int32; F <= 8 fields given by `field_ptrs` (a host array of F
// device pointers), field f of row b starting `row_stride` events after row
// b - 1, bool (one byte per event) where bit f of `bool_mask` is set, else
// int32 -> out (B, F, S) int32, launched on `stream`.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for F
// outside [1, 8].
extern "C" int repro_seg_sum(const void* seg, const void* const* field_ptrs, int F,
                             unsigned bool_mask, long long row_stride, void* out, int B, int K,
                             int S, void* stream) {
  if (F < 1 || F > kMaxFields) return static_cast<int>(cudaErrorInvalidValue);
  Fields fs{};
  for (int f = 0; f < F; ++f) fs.ptr[f] = field_ptrs[f];
  fs.is_bool = bool_mask;
  fs.n = F;
  fs.row_stride = row_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* seg_p = static_cast<const int32_t*>(seg);
  auto* out_p = static_cast<int32_t*>(out);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (static_cast<size_t>(F) * S + 3) / 4 * sizeof(int4);
  if (smem <= kMaxShared) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(seg_sum_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    const int threads = K >= kMaxThreads ? kMaxThreads : max(32, (K + 31) / 32 * 32);
    seg_sum_shared<<<B, threads, smem, st>>>(seg_p, fs, out_p, K, S);
  } else {
    const int64_t n = static_cast<int64_t>(B) * F * S;
    zero_i32<<<1024, kGlobalThreads, 0, st>>>(out_p, n);
    const dim3 grid((K + kGlobalThreads - 1) / kGlobalThreads, B);
    if (K > 0) seg_sum_global<<<grid, kGlobalThreads, 0, st>>>(seg_p, fs, out_p, K, S);
  }
  return static_cast<int>(cudaGetLastError());
}
