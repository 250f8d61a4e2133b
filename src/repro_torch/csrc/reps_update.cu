// reps_tick: one fused REPS step per connection — Algorithm 1 onAck ->
// onFailureDetection -> Algorithm 2 getNextEV over the 8-deep EV ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/reps_update.py
// (reps_tick_pallas / _reps_tick_kernel), which ran the same selects over
// (128, 8) VMEM blocks of connections with the ring on the lane axis.
//
// There is no traffic between connections, so the design is one thread per
// connection with its 8 ring entries and validity bits in registers
// (fully unrolled), every select branch-free as in the reference kernel, and
// the result written once.  Masks and flags are bool tensors (one byte
// each); an event class passed as a null pointer is all-zero, which makes
// its algorithm a no-op — so the engine's feedback, RTO and injection
// stages each map onto one launch without allocating zero masks.
//
// What bounds it: per connection it reads and writes 2 x 8 ring words plus
// a dozen scalars (~150 bytes in, ~80 out), so at N = 128 connections it is
// a few tens of KB and bound by launch latency.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBuf = 8;  // paper buffer depth
constexpr int kThreads = 128;

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ bool flag(const uint8_t* p, int64_t i) {
  return p != nullptr && p[i] != 0;
}

__global__ void reps_tick_kernel(
    const int32_t* __restrict__ buf_ev, const uint8_t* __restrict__ buf_valid,
    const int32_t* __restrict__ head, const int32_t* __restrict__ num_valid,
    const int32_t* __restrict__ explore, const uint8_t* __restrict__ freezing,
    const int32_t* __restrict__ exit_freeze, const int32_t* __restrict__ n_cached,
    const uint8_t* __restrict__ ack_mask, const int32_t* __restrict__ ack_ev,
    const uint8_t* __restrict__ ack_ecn, const uint8_t* __restrict__ timeout_mask,
    const uint8_t* __restrict__ send_mask, const int32_t* __restrict__ rand_ev, int now,
    int bdp, int freeze_to, int64_t n, int32_t* __restrict__ o_buf_ev,
    uint8_t* __restrict__ o_buf_valid, int32_t* __restrict__ o_head,
    int32_t* __restrict__ o_num_valid, int32_t* __restrict__ o_explore,
    uint8_t* __restrict__ o_freezing, int32_t* __restrict__ o_exit_freeze,
    int32_t* __restrict__ o_n_cached, int32_t* __restrict__ o_ev) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  int32_t ev[kBuf];
  bool valid[kBuf];
#pragma unroll
  for (int j = 0; j < kBuf; ++j) {
    ev[j] = buf_ev[i * kBuf + j];
    valid[j] = buf_valid[i * kBuf + j] != 0;
  }
  int h = head[i];
  int nv = num_valid[i];
  int ex = explore[i];
  int ef = exit_freeze[i];
  int nc = n_cached[i];
  bool fr = freezing[i] != 0;

  // ---- Algorithm 1: onAck (ECN-marked ACKs are discarded) -------------
  const bool cache = flag(ack_mask, i) && !flag(ack_ecn, i);
  const int aev = ack_ev != nullptr ? ack_ev[i] : 0;
  bool slot_valid = false;
#pragma unroll
  for (int j = 0; j < kBuf; ++j) slot_valid = slot_valid || (j == h && valid[j]);
  nv = (cache && !slot_valid) ? nv + 1 : nv;
#pragma unroll
  for (int j = 0; j < kBuf; ++j) {
    const bool wr = cache && j == h;
    ev[j] = wr ? aev : ev[j];
    valid[j] = valid[j] || wr;
  }
  h = cache ? floor_mod(h + 1, kBuf) : h;
  nc = cache ? nc + 1 : nc;
  const bool exit_now = cache && fr && now > ef;
  fr = fr && !exit_now;
  ex = exit_now ? bdp : ex;

  // ---- Algorithm 1: onFailureDetection ---------------------------------
  const bool enter = flag(timeout_mask, i) && !fr && ex == 0;
  fr = fr || enter;
  // int32 wraparound add, as the reference's jnp int32 arithmetic
  ef = enter ? static_cast<int>(static_cast<unsigned>(now) + static_cast<unsigned>(freeze_to))
             : ef;

  // ---- Algorithm 2: onSend / getNextEV ----------------------------------
  const bool send = flag(send_mask, i);
  const bool explore_now = send && (nc == 0 || (nv == 0 && !fr) || ex > 0);
  const bool recycle = send && !explore_now;
  const bool pop_valid = recycle && nv > 0;
  const bool reuse = recycle && nv == 0;
  const int off = pop_valid ? floor_mod(h - nv, kBuf) : h;
  int picked = 0;
#pragma unroll
  for (int j = 0; j < kBuf; ++j) picked = (j == off) ? ev[j] : picked;
  const int rev = rand_ev != nullptr ? rand_ev[i] : 0;
  o_ev[i] = recycle ? picked : rev;
#pragma unroll
  for (int j = 0; j < kBuf; ++j) valid[j] = valid[j] && !(pop_valid && j == off);
  nv = pop_valid ? nv - 1 : nv;
  h = reuse ? floor_mod(h + 1, kBuf) : h;
  ex = explore_now ? max(ex - 1, 0) : ex;

#pragma unroll
  for (int j = 0; j < kBuf; ++j) {
    o_buf_ev[i * kBuf + j] = ev[j];
    o_buf_valid[i * kBuf + j] = valid[j] ? 1 : 0;
  }
  o_head[i] = h;
  o_num_valid[i] = nv;
  o_explore[i] = ex;
  o_freezing[i] = fr ? 1 : 0;
  o_exit_freeze[i] = ef;
  o_n_cached[i] = nc;
}

}  // namespace

// State: buf_ev (n, 8) int32, buf_valid (n, 8) bool, head/num_valid/explore
// (n,) int32, freezing (n,) bool, exit_freeze/n_cached (n,) int32.  Events
// (nullable): ack_mask bool, ack_ev int32, ack_ecn bool, timeout_mask bool,
// send_mask bool, rand_ev int32.  Outputs mirror the state, then ev (n,).
extern "C" int repro_reps_tick(
    const void* buf_ev, const void* buf_valid, const void* head, const void* num_valid,
    const void* explore, const void* freezing, const void* exit_freeze, const void* n_cached,
    const void* ack_mask, const void* ack_ev, const void* ack_ecn, const void* timeout_mask,
    const void* send_mask, const void* rand_ev, int now, int bdp, int freeze_to, long long n,
    void* o_buf_ev, void* o_buf_valid, void* o_head, void* o_num_valid, void* o_explore,
    void* o_freezing, void* o_exit_freeze, void* o_n_cached, void* o_ev, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  reps_tick_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(buf_ev), static_cast<const uint8_t*>(buf_valid),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(num_valid),
      static_cast<const int32_t*>(explore), static_cast<const uint8_t*>(freezing),
      static_cast<const int32_t*>(exit_freeze), static_cast<const int32_t*>(n_cached),
      static_cast<const uint8_t*>(ack_mask), static_cast<const int32_t*>(ack_ev),
      static_cast<const uint8_t*>(ack_ecn), static_cast<const uint8_t*>(timeout_mask),
      static_cast<const uint8_t*>(send_mask), static_cast<const int32_t*>(rand_ev), now, bdp,
      freeze_to, static_cast<int64_t>(n), static_cast<int32_t*>(o_buf_ev),
      static_cast<uint8_t*>(o_buf_valid), static_cast<int32_t*>(o_head),
      static_cast<int32_t*>(o_num_valid), static_cast<int32_t*>(o_explore),
      static_cast<uint8_t*>(o_freezing), static_cast<int32_t*>(o_exit_freeze),
      static_cast<int32_t*>(o_n_cached), static_cast<int32_t*>(o_ev));
  return static_cast<int>(cudaGetLastError());
}
