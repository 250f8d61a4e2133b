// next_queue: the arrivals stage's whole routing step in one launch — for
// each arrival, the queue it enters next in the 2- or 3-tier fat tree:
// ECMP hash of (flow, EV, switch salt) at each choice hop (salt src_tor at
// the ToR uplink; agg_global + 7919 at the 3-tier agg uplink), or under
// adaptive routing the first least-loaded port of q_len (+ q_penalty);
// down-direction ports follow the destination.
//
// Redesign for this card of the ecmp_hash port of the Pallas TPU kernel
// src/repro/kernels/ecmp_hash.py (ecmp_hash_pallas / _mix_kernel), which
// hashed (8, 128) tiles on the VPU and left the rest of the routing step
// (repro.netsim.topology.Topology.next_queue and the engine's gathers) to
// XLA's fused elementwise code.  Run eagerly from PyTorch, that rest was
// about 30 small launches per tick around the hash launch (one or two); here
// it is one launch.  The hash is ecmp_mix.cuh, shared with ecmp_hash.cu.
//
// Two forms, by whether a_idx is given:
//   - reference form (a_idx null): at_injection is a bool flag, src and dst
//     are the hosts of each arrival — Topology.next_queue's signature;
//   - engine form: the arrivals are the compacted packet slots a_idx (a slot
//     >= n_pkt is no arrival and gets n_queues), their fields are the rows of
//     the engine's gathered packet table (at_injection is then the int32 hop
//     count, 0 at injection), and src / dst are the connection tables,
//     gathered here through the connection id (clamped to [0, n_conns)).
//
// Rows: a fleet of B runs of one scenario routes every run's arrivals in this
// one launch.  The arrival arrays are (B, K) and flattened (thread i serves
// row i / K); q_len is (B, n_queues), each row read at row * n_queues;
// q_penalty is one (n_queues,) row shared by every run (pen_row_stride 0: one
// failure schedule) or (B, n_queues); the engine form's connection tables
// are one (n_conns,) pair shared by every run (conn_row_stride 0: one
// workload) or one pair per row (conn_row_stride n_conns: rows with their own
// workloads), read at row * conn_row_stride + c.  B = 1 is the one-run call.
//
// What bounds it: at the engine's K = 512 arrivals it reads ~20 bytes and
// writes 4 per arrival (plus q_len under adaptive), ~12 KB per row, a few ns
// of HBM time: it is bound by launch latency, like the rest of the tick, at
// B = 64 rows too (~0.8 MB, 32768 threads in 256 blocks).
// Design: one thread per arrival, the ragged end masked by the thread index;
// every row load goes out before the first branch on one; empty slots stop
// before any gather, so no table or q_len read happens at a garbage index.
// The branch on the arrival's region comes first, so a fresh injection's cur
// queue (-1) never reaches the floor divisions and modulos that the
// reference's arithmetic needs (C's / and % truncate; floor_div / floor_mod
// reproduce Python's and JAX's floor semantics for the regions that do use
// them).  The adaptive pick is a loop over <= A (or U, U2) ports with a
// strict <, so the first least wins, as torch.argmin and jnp.argmin.
#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#include "ecmp_mix.cuh"

namespace {

constexpr int kThreads = 128;

// The queue-id layout, in the order of repro_torch.kernels.next_queue's
// RouteGeometry; the fields a tier does not use are 0.
struct Fabric {
  int tiers, hosts_per_tor, n_tors, uplinks_per_tor, aggs_per_pod, agg_uplinks, tors_per_pod,
      n_pods;
  int t0_up, agg_up, core_down, agg_down, t0_down, n_queues;
};
constexpr int kFabricInts = sizeof(Fabric) / sizeof(int);
static_assert(kFabricInts == 14, "Fabric must mirror RouteGeometry");

struct Arrivals {
  const void* at_injection;  // uint8 flags; int32 hop counts in the engine form
  const int32_t* cur;
  const int32_t* flow;
  const int32_t* ev;
  const int32_t* src;    // per arrival; the connection table in the engine form
  const int32_t* dst;
  const int32_t* a_idx;  // engine form: packet slots; null: reference form
  int n_pkt, n_conns;
  int conn_row_stride;   // engine form: 0 (one table for all rows) or n_conns
};

__device__ __forceinline__ int floor_mod(int x, int m) {  // m >= 1
  const int r = x % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int floor_div(int x, int m) {  // m >= 1
  return (x - floor_mod(x, m)) / m;
}

// q_len[q] (+ q_penalty[q]) with int32 wrap, as the plain version's int32 add
__device__ __forceinline__ int load_len(const int32_t* __restrict__ q_len,
                                        const int32_t* __restrict__ q_pen, int q) {
  return q_pen == nullptr ? q_len[q]
                          : static_cast<int>(static_cast<uint32_t>(q_len[q]) +
                                             static_cast<uint32_t>(q_pen[q]));
}

// the port a choice hop takes among the n queues from `base`
__device__ __forceinline__ int choose(bool adaptive, const int32_t* __restrict__ q_len,
                                      const int32_t* __restrict__ q_pen, int base, int n,
                                      int flow, int ev, int salt) {
  if (!adaptive) return static_cast<int>(ecmp_mix::port(flow, ev, salt, n));
  int best = 0, best_len = load_len(q_len, q_pen, base);
  for (int j = 1; j < n; ++j) {
    const int len = load_len(q_len, q_pen, base + j);
    if (len < best_len) {  // strict: the first least wins
      best = j;
      best_len = len;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
    next_queue_kernel(const Fabric f, const Arrivals a, const int32_t* __restrict__ q_len_rows,
                      const int32_t* __restrict__ q_pen_rows, int pen_row_stride, bool adaptive,
                      int k, int row_len, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  // this arrival's run: its queue lengths (and penalty, unless shared)
  const int row = i / row_len;
  const int32_t* __restrict__ q_len = q_len_rows + static_cast<int64_t>(row) * f.n_queues;
  const int32_t* __restrict__ q_pen =
      q_pen_rows == nullptr ? nullptr : q_pen_rows + static_cast<int64_t>(row) * pen_row_stride;
  const bool engine = a.a_idx != nullptr;
  // every row holds a value for every slot (the engine gathers clamped
  // rows), so all loads go out before the first branch on one
  const int slot = engine ? a.a_idx[i] : 0;
  const int cur = a.cur[i], flow = a.flow[i], ev = a.ev[i];
  const bool at_inj = engine ? static_cast<const int32_t*>(a.at_injection)[i] == 0
                             : static_cast<const uint8_t*>(a.at_injection)[i] != 0;
  int src, dst;
  if (engine) {
    if (slot >= a.n_pkt) {  // no arrival: the padding queue, and no gather
      out[i] = f.n_queues;
      return;
    }
    const int64_t c = static_cast<int64_t>(row) * a.conn_row_stride +
                      min(max(flow, 0), a.n_conns - 1);
    src = a.src[c];
    dst = a.dst[c];
  } else {
    src = a.src[i];
    dst = a.dst[i];
  }

  const int H = f.hosts_per_tor;
  const int src_tor = floor_div(src, H), dst_tor = floor_div(dst, H);
  const int t0_down = f.t0_down + dst_tor * H + floor_mod(dst, H);
  int nxt;
  if (f.tiers == 2) {
    const int U = f.uplinks_per_tor;
    if (at_inj) {  // leaving the source host: its ToR's uplink, or straight down
      const int base = f.t0_up + src_tor * U;
      nxt = src_tor == dst_tor ? t0_down
                               : base + choose(adaptive, q_len, q_pen, base, U, flow, ev, src_tor);
    } else if (cur < f.core_down) {  // a ToR uplink reached spine cur % U: down to dst's ToR
      nxt = f.core_down + floor_mod(cur - f.t0_up, U) * f.n_tors + dst_tor;
    } else {
      nxt = t0_down;
    }
  } else {
    const int A = f.aggs_per_pod, U2 = f.agg_uplinks, Tp = f.tors_per_pod;
    const int src_pod = floor_div(src_tor, Tp), dst_pod = floor_div(dst_tor, Tp);
    const int dst_tor_local = floor_mod(dst_tor, Tp);
    if (at_inj) {
      const int base = f.t0_up + src_tor * A;
      nxt = src_tor == dst_tor ? t0_down
                               : base + choose(adaptive, q_len, q_pen, base, A, flow, ev, src_tor);
    } else if (cur < f.agg_up) {  // a ToR uplink reached agg cur % A of the source pod
      const int agg = src_pod * A + floor_mod(cur - f.t0_up, A);
      if (src_pod == dst_pod) {
        nxt = f.agg_down + agg * Tp + dst_tor_local;
      } else {
        const int base = f.agg_up + agg * U2;
        nxt = base + choose(adaptive, q_len, q_pen, base, U2, flow, ev, agg + 7919);
      }
    } else if (cur < f.core_down) {  // an agg uplink (p*A+a)*U2+u reached core a*U2+u
      const int rel = cur - f.agg_up;
      const int core = floor_mod(floor_div(rel, U2), A) * U2 + floor_mod(rel, U2);
      nxt = f.core_down + core * f.n_pods + dst_pod;
    } else if (cur < f.agg_down) {  // a core downlink reached agg core / U2 of dst's pod
      const int dst_agg = floor_div(floor_div(cur - f.core_down, f.n_pods), U2);
      nxt = f.agg_down + (dst_pod * A + dst_agg) * Tp + dst_tor_local;
    } else {
      nxt = t0_down;
    }
  }
  out[i] = nxt;
}

}  // namespace

// fabric: host array of kFabricInts ints (RouteGeometry's order; the wrapper
// checks the divisors >= 1).  k = B * row_len arrivals of B rows: at_injection
// k bool flags, or k int32 hop counts in the engine form; cur, flow, ev: k
// int32; src, dst: k int32 hosts, or in the engine form int32 connection
// tables of n_conns >= 1 entries per row, conn_row_stride apart (0: one pair
// shared by the rows, n_conns: one per row); a_idx: k int32 packet slots
// (engine form) or null.  q_len: (B, n_queues) int32, read only under
// adaptive; q_penalty: null, or int32 rows pen_row_stride apart (0: one
// (n_queues,) row for all, n_queues: one per row).  out: k int32.  Returns
// cudaGetLastError().
extern "C" int repro_next_queue(const int* fabric, const void* at_injection, const void* cur,
                                const void* flow, const void* ev, const void* src,
                                const void* dst, const void* a_idx, int n_pkt, int n_conns,
                                int conn_row_stride, const void* q_len, const void* q_penalty,
                                int pen_row_stride, int adaptive, int k, int row_len, void* out,
                                void* stream) {
  Fabric f;
  std::memcpy(&f, fabric, sizeof f);
  const Arrivals a{at_injection,
                   static_cast<const int32_t*>(cur),
                   static_cast<const int32_t*>(flow),
                   static_cast<const int32_t*>(ev),
                   static_cast<const int32_t*>(src),
                   static_cast<const int32_t*>(dst),
                   static_cast<const int32_t*>(a_idx),
                   n_pkt,
                   n_conns,
                   conn_row_stride};
  if (k > 0 && row_len > 0) {
    next_queue_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        f, a, static_cast<const int32_t*>(q_len), static_cast<const int32_t*>(q_penalty),
        pen_row_stride, adaptive != 0, k, row_len, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
