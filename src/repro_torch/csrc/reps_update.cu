// reps_tick: one REPS tick per connection in one launch — R rounds of
// Algorithm 1 onAck, then onFailureDetection, then Algorithm 2 getNextEV,
// over the 8-deep EV ring.
//
// Replaces the Pallas TPU kernel src/repro/kernels/reps_update.py
// (reps_tick_pallas / _reps_tick_kernel), which ran one onAck, one
// onFailureDetection and one getNextEV as branch-free selects over
// (128, 8) VMEM blocks of connections with the ring on the lane axis.  With
// R = 1 this kernel computes exactly that function; with R > 1 it computes
// R - 1 further onAck passes first, which is what the engine's feedback
// rounds do between ticks.
//
// What bounds it: per connection it reads 40 ring bytes, 14 scalar bytes
// and up to 6 + 3R event bytes, and writes 40 + 22 bytes, so at the
// engine's N = 128 connections a launch moves under 20 KB (a few ns of
// HBM time) and is bound by launch latency and by the host's cost of
// issuing it.  The design answers with fewer launches: the engine's four
// REPS passes per tick (two feedback rounds, RTO, injection) are one launch,
// with the state in registers across all of them, the ring read once and
// written once.  Connections share no data, so it stays one thread per
// connection; a ring row (32 B of EVs, 8 B of valid bytes) moves as two
// 16-byte and one 8-byte access, and every load is issued before the first
// select that depends on one.  In registers the validity bytes are one
// 8-bit mask and the pop reads its slot through a three-level select tree,
// which keeps the dependent chain short (the work is latency, not bytes).
// The rounds' event pointers travel by value in the kernel's parameters (no
// device-side pointer table, no copy to the device); a null pointer is an
// all-zero event class, whose algorithm is then a no-op.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBuf = 8;  // paper buffer depth
constexpr int kMaxRounds = 4;
constexpr int kThreads = 128;

struct AckRounds {
  const uint8_t* mask[kMaxRounds];
  const int32_t* ev[kMaxRounds];
  const uint8_t* ecn[kMaxRounds];
  int n;
};

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ bool flag(const uint8_t* p, int64_t i) {
  return p != nullptr && p[i] != 0;
}

__device__ __forceinline__ int32_t word(const int32_t* p, int64_t i) {
  return p != nullptr ? p[i] : 0;
}

// bit j of the ring's validity mask for slot j; 0 for a slot outside the
// ring, which (as the reference's one-hot compare) then matches no lane
__device__ __forceinline__ unsigned slot_bit(int j) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(kBuf) ? 1u << j : 0u;
}

// ev[off] by a three-level select tree (0 for an off outside the ring)
__device__ __forceinline__ int pick_slot(const int (&ev)[kBuf], int off) {
  const bool hi = off & 4, mid = off & 2, lo = off & 1;
  const int a0 = hi ? ev[4] : ev[0], a1 = hi ? ev[5] : ev[1];
  const int a2 = hi ? ev[6] : ev[2], a3 = hi ? ev[7] : ev[3];
  const int b0 = mid ? a2 : a0, b1 = mid ? a3 : a1;
  return slot_bit(off) ? (lo ? b1 : b0) : 0;
}

__global__ void __launch_bounds__(kThreads) reps_tick_kernel(
    const int32_t* __restrict__ buf_ev, const uint8_t* __restrict__ buf_valid,
    const int32_t* __restrict__ head, const int32_t* __restrict__ num_valid,
    const int32_t* __restrict__ explore, const uint8_t* __restrict__ freezing,
    const int32_t* __restrict__ exit_freeze, const int32_t* __restrict__ n_cached,
    const AckRounds acks, const uint8_t* __restrict__ timeout_mask,
    const uint8_t* __restrict__ send_mask, const int32_t* __restrict__ rand_ev, int now,
    int bdp, int freeze_to, int64_t n, int32_t* __restrict__ o_buf_ev,
    uint8_t* __restrict__ o_buf_valid, int32_t* __restrict__ o_head,
    int32_t* __restrict__ o_num_valid, int32_t* __restrict__ o_explore,
    uint8_t* __restrict__ o_freezing, int32_t* __restrict__ o_exit_freeze,
    int32_t* __restrict__ o_n_cached, int32_t* __restrict__ o_ev) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;

  // ---- every load first ---------------------------------------------------
  const int4* ring4 = reinterpret_cast<const int4*>(buf_ev) + 2 * i;
  const int4 lo = ring4[0];
  const int4 hi = ring4[1];
  const uint2 vb = reinterpret_cast<const uint2*>(buf_valid)[i];
  int h = head[i];
  int nv = num_valid[i];
  int ex = explore[i];
  int ef = exit_freeze[i];
  int nc = n_cached[i];
  bool fr = freezing[i] != 0;
  bool a_mask[kMaxRounds], a_ecn[kMaxRounds];
  int a_ev[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const bool live = r < acks.n;
    a_mask[r] = live && flag(acks.mask[r], i);
    a_ev[r] = live ? word(acks.ev[r], i) : 0;
    a_ecn[r] = live && flag(acks.ecn[r], i);
  }
  const bool timeout = flag(timeout_mask, i);
  const bool send = flag(send_mask, i);
  const int rev = word(rand_ev, i);

  int ev[kBuf] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned valid = 0;  // bit j: slot j holds a valid EV
#pragma unroll
  for (int j = 0; j < kBuf; ++j) {
    const unsigned w = j < 4 ? vb.x : vb.y;
    valid |= (((w >> (8 * (j & 3))) & 0xffu) != 0 ? 1u : 0u) << j;
  }

  // ---- Algorithm 1: onAck, one pass per round (ECN-marked ACKs discarded) -
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const bool cache = a_mask[r] && !a_ecn[r];
    const unsigned hbit = slot_bit(h);
    nv = (cache && !(valid & hbit)) ? nv + 1 : nv;
#pragma unroll
    for (int j = 0; j < kBuf; ++j) ev[j] = (cache && j == h) ? a_ev[r] : ev[j];
    valid |= cache ? hbit : 0u;
    h = cache ? floor_mod(h + 1, kBuf) : h;
    nc = cache ? nc + 1 : nc;
    const bool exit_now = cache && fr && now > ef;
    fr = fr && !exit_now;
    ex = exit_now ? bdp : ex;
  }

  // ---- Algorithm 1: onFailureDetection -----------------------------------
  const bool enter = timeout && !fr && ex == 0;
  fr = fr || enter;
  // int32 wraparound add, as the reference's jnp int32 arithmetic
  ef = enter ? static_cast<int>(static_cast<unsigned>(now) + static_cast<unsigned>(freeze_to))
             : ef;

  // ---- Algorithm 2: onSend / getNextEV ------------------------------------
  const bool explore_now = send && (nc == 0 || (nv == 0 && !fr) || ex > 0);
  const bool recycle = send && !explore_now;
  const bool pop_valid = recycle && nv > 0;
  const bool reuse = recycle && nv == 0;
  const int off = pop_valid ? floor_mod(h - nv, kBuf) : h;
  const int picked = pick_slot(ev, off);
  valid &= pop_valid ? ~slot_bit(off) : ~0u;
  nv = pop_valid ? nv - 1 : nv;
  h = reuse ? floor_mod(h + 1, kBuf) : h;
  ex = explore_now ? max(ex - 1, 0) : ex;

  // ---- one store per field -------------------------------------------------
  int4* out4 = reinterpret_cast<int4*>(o_buf_ev) + 2 * i;
  out4[0] = make_int4(ev[0], ev[1], ev[2], ev[3]);
  out4[1] = make_int4(ev[4], ev[5], ev[6], ev[7]);
  uint2 ov = make_uint2(0u, 0u);
#pragma unroll
  for (int j = 0; j < kBuf; ++j) {
    const unsigned byte = (valid >> j) & 1u;
    if (j < 4) ov.x |= byte << (8 * j);
    else ov.y |= byte << (8 * (j - 4));
  }
  reinterpret_cast<uint2*>(o_buf_valid)[i] = ov;
  o_head[i] = h;
  o_num_valid[i] = nv;
  o_explore[i] = ex;
  o_freezing[i] = fr ? 1 : 0;
  o_exit_freeze[i] = ef;
  o_n_cached[i] = nc;
  o_ev[i] = recycle ? picked : rev;
}

}  // namespace

// State: buf_ev (n, 8) int32 (16-byte aligned), buf_valid (n, 8) bool
// (8-byte aligned), head/num_valid/explore (n,) int32, freezing (n,) bool,
// exit_freeze/n_cached (n,) int32.  ACK rounds: `ack_ptrs` is a host array
// of 3 x kMaxRounds pointers — the masks (bool), then the EVs (int32), then
// the ECN flags (bool), of rounds 0 .. rounds-1 — copied into the launch's
// parameters.  Every event pointer may be null (an all-zero class); the
// timeout and send masks are bool, rand_ev int32.  Outputs mirror the state
// (same alignment), then ev (n,).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for rounds outside [0, kMaxRounds].
extern "C" int repro_reps_tick(
    const void* buf_ev, const void* buf_valid, const void* head, const void* num_valid,
    const void* explore, const void* freezing, const void* exit_freeze, const void* n_cached,
    const void* const* ack_ptrs, int rounds, const void* timeout_mask, const void* send_mask,
    const void* rand_ev, int now, int bdp, int freeze_to, long long n, void* o_buf_ev,
    void* o_buf_valid, void* o_head, void* o_num_valid, void* o_explore, void* o_freezing,
    void* o_exit_freeze, void* o_n_cached, void* o_ev, void* stream) {
  if (rounds < 0 || rounds > kMaxRounds) return static_cast<int>(cudaErrorInvalidValue);
  AckRounds acks{};
  acks.n = rounds;
  for (int r = 0; r < rounds; ++r) {
    acks.mask[r] = static_cast<const uint8_t*>(ack_ptrs[r]);
    acks.ev[r] = static_cast<const int32_t*>(ack_ptrs[kMaxRounds + r]);
    acks.ecn[r] = static_cast<const uint8_t*>(ack_ptrs[2 * kMaxRounds + r]);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  reps_tick_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const int32_t*>(buf_ev), static_cast<const uint8_t*>(buf_valid),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(num_valid),
      static_cast<const int32_t*>(explore), static_cast<const uint8_t*>(freezing),
      static_cast<const int32_t*>(exit_freeze), static_cast<const int32_t*>(n_cached), acks,
      static_cast<const uint8_t*>(timeout_mask), static_cast<const uint8_t*>(send_mask),
      static_cast<const int32_t*>(rand_ev), now, bdp, freeze_to, static_cast<int64_t>(n),
      static_cast<int32_t*>(o_buf_ev), static_cast<uint8_t*>(o_buf_valid),
      static_cast<int32_t*>(o_head), static_cast<int32_t*>(o_num_valid),
      static_cast<int32_t*>(o_explore), static_cast<uint8_t*>(o_freezing),
      static_cast<int32_t*>(o_exit_freeze), static_cast<int32_t*>(o_n_cached),
      static_cast<int32_t*>(o_ev));
  return static_cast<int>(cudaGetLastError());
}
