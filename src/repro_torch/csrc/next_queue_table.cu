// next_queue_table: the routing step of a generated fabric (topogen's clos3,
// rail and mesh) in one launch — for each arrival, the queue it enters next
// by the fabric's tables, as repro.netsim.topology.TableTopology.next_queue:
//
//   sw   = at_injection ? host_sw[clip(src)] : q_sw[clip(cur)], clipped to [0, NS)
//   down = down_next[sw, clip(dst)]            (>= 0: route down, done)
//   else up_base[sw, dst] + choice, choice = ecmp_hash(flow, ev, salt[sw],
//        max(up_deg[sw], 1)), or under adaptive routing the first least of
//        q_len (+ q_penalty) over max_up_deg candidates, lanes >= up_deg[sw]
//        reading 2**30.
//
// The table form of the routing kernel next_queue.cu, and like it the
// redesign for this card of the Pallas TPU kernel
// src/repro/kernels/ecmp_hash.py (ecmp_hash_pallas), which hashed (8, 128)
// tiles and left the table gathers, the adaptive argmin and the selects of
// TableTopology.next_queue to XLA: run eagerly from PyTorch, that is about
// a dozen launches per tick around the hash; here it is one.  The hash is
// ecmp_mix.cuh, shared with ecmp_hash.cu and next_queue.cu.
//
// Two forms, by whether a_idx is given, and a fleet's row axis, exactly as
// next_queue.cu takes them (see there): the reference form (at_injection a
// bool flag, src and dst the hosts of each arrival) and the engine form (the
// compacted packet slots a_idx, a slot >= n_pkt getting n_queues without any
// gather; at_injection the int32 hop count; src and dst the connection
// tables, shared by the rows or one pair per row, read through the clamped
// connection id); q_len (B, n_queues), q_penalty shared or per row.
//
// What bounds it: per arrival ~20 bytes of its row, 8 of the connection
// tables, 3-4 table words (host_sw or q_sw, down_next, then up_base, up_deg,
// salt) and, under adaptive routing, max_up_deg words of q_len: a few KB per
// tick, so launch latency, as the rest of the tick.
// Design: one thread per arrival, the ragged end masked by the thread index;
// every index into a table is clamped before the load, so garbage lanes read
// real entries (their outputs are masked by the caller, as the reference's);
// the adaptive pick is a loop with a strict <, so the first least wins, as
// torch.argmin and jnp.argmin.
#include <cuda_runtime.h>
#include <cstdint>

#include "ecmp_mix.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnusedLane = 1 << 30;  // the reference's fill for lanes >= up_deg

struct Tables {
  const int32_t* host_sw;    // (NH,) host -> its ToR
  const int32_t* q_sw;       // (NQ,) queue -> the switch it feeds (-1: host downlink)
  const int32_t* up_base;    // (NS, NH) first candidate up queue toward dst
  const int32_t* up_deg;     // (NS,) candidate count (0: a top switch)
  const int32_t* down_next;  // (NS, NH) down queue toward dst, -1: go up
  const int32_t* salt;       // (NS,) ECMP salt plane
  int n_hosts, n_queues, n_switches, max_up_deg;  // max_up_deg >= 1
};

struct Arrivals {
  const void* at_injection;  // uint8 flags; int32 hop counts in the engine form
  const int32_t* cur;
  const int32_t* flow;
  const int32_t* ev;
  const int32_t* src;  // per arrival; the connection table in the engine form
  const int32_t* dst;
  const int32_t* a_idx;  // engine form: packet slots; null: reference form
  int n_pkt, n_conns;
  int conn_row_stride;  // engine form: 0 (one table for all rows) or n_conns
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__global__ void __launch_bounds__(kThreads)
    next_queue_table_kernel(const Tables t, const Arrivals a,
                            const int32_t* __restrict__ q_len_rows,
                            const int32_t* __restrict__ q_pen_rows, int pen_row_stride,
                            bool adaptive, int k, int row_len, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= k) return;
  const int row = i / row_len;
  const int32_t* __restrict__ q_len = q_len_rows + static_cast<int64_t>(row) * t.n_queues;
  const int32_t* __restrict__ q_pen =
      q_pen_rows == nullptr ? nullptr : q_pen_rows + static_cast<int64_t>(row) * pen_row_stride;
  const bool engine = a.a_idx != nullptr;
  const int slot = engine ? a.a_idx[i] : 0;
  const int cur = a.cur[i], flow = a.flow[i], ev = a.ev[i];
  const bool at_inj = engine ? static_cast<const int32_t*>(a.at_injection)[i] == 0
                             : static_cast<const uint8_t*>(a.at_injection)[i] != 0;
  int src, dst;
  if (engine) {
    if (slot >= a.n_pkt) {  // no arrival: the padding queue, and no gather
      out[i] = t.n_queues;
      return;
    }
    const int64_t c = static_cast<int64_t>(row) * a.conn_row_stride +
                      clampi(flow, 0, a.n_conns - 1);
    src = a.src[c];
    dst = a.dst[c];
  } else {
    src = a.src[i];
    dst = a.dst[i];
  }
  const int sw_raw = at_inj ? t.host_sw[clampi(src, 0, t.n_hosts - 1)]
                            : t.q_sw[clampi(cur, 0, t.n_queues - 1)];
  const int sw = clampi(sw_raw, 0, t.n_switches - 1);
  const int64_t cell = static_cast<int64_t>(sw) * t.n_hosts + clampi(dst, 0, t.n_hosts - 1);
  const int down = t.down_next[cell];
  if (down >= 0) {
    out[i] = down;
    return;
  }
  const int base = t.up_base[cell];
  const int deg = t.up_deg[sw];
  int choice;
  if (!adaptive) {
    choice = static_cast<int>(ecmp_mix::port(flow, ev, t.salt[sw], static_cast<uint32_t>(max(deg, 1))));
  } else {
    choice = 0;
    int best = kUnusedLane;
    for (int j = 0; j < t.max_up_deg; ++j) {
      int len = kUnusedLane;
      if (j < deg) {
        const int q = clampi(base + j, 0, t.n_queues - 1);
        // q_len + q_penalty with int32 wrap, as the plain version's int32 add
        len = q_pen == nullptr ? q_len[q]
                               : static_cast<int>(static_cast<uint32_t>(q_len[q]) +
                                                  static_cast<uint32_t>(q_pen[q]));
      }
      if (j == 0 || len < best) {  // strict: the first least wins
        best = len;
        choice = j;
      }
    }
  }
  out[i] = base + choice;
}

}  // namespace

// Tables: int32 device arrays host_sw (n_hosts), q_sw (n_queues), up_base and
// down_next (n_switches, n_hosts), up_deg and salt (n_switches); max_up_deg
// >= 1 (the wrapper passes max(spec.max_up_deg, 1)).  The arrivals, rows,
// q_len and q_penalty as repro_next_queue takes them.  out: k int32.
// Returns cudaGetLastError().
extern "C" int repro_next_queue_table(const void* host_sw, const void* q_sw,
                                      const void* up_base, const void* up_deg,
                                      const void* down_next, const void* salt, int n_hosts,
                                      int n_queues, int n_switches, int max_up_deg,
                                      const void* at_injection, const void* cur,
                                      const void* flow, const void* ev, const void* src,
                                      const void* dst, const void* a_idx, int n_pkt,
                                      int n_conns, int conn_row_stride, const void* q_len,
                                      const void* q_penalty, int pen_row_stride, int adaptive,
                                      int k, int row_len, void* out, void* stream) {
  const Tables t{static_cast<const int32_t*>(host_sw),
                 static_cast<const int32_t*>(q_sw),
                 static_cast<const int32_t*>(up_base),
                 static_cast<const int32_t*>(up_deg),
                 static_cast<const int32_t*>(down_next),
                 static_cast<const int32_t*>(salt),
                 n_hosts,
                 n_queues,
                 n_switches,
                 max_up_deg};
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
    next_queue_table_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        t, a, static_cast<const int32_t*>(q_len), static_cast<const int32_t*>(q_penalty),
        pen_row_stride, adaptive != 0, k, row_len, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
