# Frozen copy of the port's plain formulation (src/repro_torch/netsim/config.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""Simulator configuration (counterpart of ``repro.netsim.config``).

Time is discretized at one MTU serialization time on the reference link
(4 KiB @ 400 Gb/s ≈ 82 ns).  All latencies and timeouts are in ticks; the
helpers convert from the paper's physical constants (§4.1: 4 KiB MTU,
400 Gb/s links, ≈ 1 µs ≈ 12 ticks per hop, RTO = 70 µs ≈ 854 ticks, queue
= 1 BDP with RED thresholds Kmin = 20 % and Kmax = 80 % of it).

The port keeps every field and default of the reference so that one
configuration means one scenario in both packages.  The two backend
fields, ``arrivals_backend`` and ``kernels_backend``, accept only
``"auto"``: the device alone picks the path.  A simulation on a CUDA
device runs the hand-written kernels of ``repro_torch.kernels``, one on the
CPU their plain versions (``kernels/ref.py``); no value sends a simulation
on the card through a plain version.
"""
from __future__ import annotations

import dataclasses
import math

TICK_NS = 81.92  # 4 KiB at 400 Gb/s
INT32_MAX = 2**31 - 1
BACKENDS = ("auto",)


def ns_to_ticks(ns: float) -> int:
    return max(1, int(round(ns / TICK_NS)))


def us_to_ticks(us: float) -> int:
    return ns_to_ticks(us * 1000.0)


def checked_auto_pkt_slots(
    n_conns: int, max_cwnd_pkts: int, n_hosts: int, pin: int = 0
) -> int:
    """THE packet-slot sizing rule (``n_conns * max_cwnd + slack``, rounded
    to a power of two), in python ints and checked against the int32 slot
    namespace: near 10**6 connections the product crosses 2**31 long before
    any tensor exists."""
    raw = int(n_conns) * int(max_cwnd_pkts) + 4 * int(n_hosts) + 64
    slots = int(pin) if pin else 1 << max(1, math.ceil(math.log2(max(raw, 2))))
    if slots > INT32_MAX:
        raise ValueError(
            f"pkt_slots auto-sizing overflows int32: n_conns={n_conns} * "
            f"max_cwnd_pkts={max_cwnd_pkts} + slack -> {raw} pkt slots "
            f"(pow2 {slots}), but slot indices are int32 (max {INT32_MAX}). "
            "Pin SimConfig.pkt_slots or reduce n_conns/max_cwnd_pkts."
        )
    return slots


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # --- topology ---------------------------------------------------------
    n_hosts: int = 128
    hosts_per_tor: int = 16
    tiers: int = 2  # 2 or 3
    uplinks_per_tor: int = 16  # 2-tier: == number of spines
    # 3-tier only:
    tors_per_pod: int = 4
    aggs_per_pod: int = 4
    agg_uplinks: int = 4  # cores per agg
    # generated fabric spec ("" = the built-in arithmetic fat-tree), e.g.
    # "clos3:pods=4,tors=2,hosts=16,aggs=4,up=4", "rail:..." or "mesh:...":
    # built by netsim/topogen.py and routed by topology.TableTopology
    fabric: str = ""

    # --- timing -----------------------------------------------------------
    hop_latency_ticks: int = 12  # 500 ns link + 500 ns switch
    ack_delay_ticks: int = 24  # ACK return latency (unqueued, 64 B)
    rto_ticks: int = 854  # 70 us
    nack_delay_ticks: int = 24  # trimmed-header return latency

    # --- queues / ECN (RED) -----------------------------------------------
    queue_capacity: int = 85  # ~1 BDP in packets
    kmin_frac: float = 0.2
    kmax_frac: float = 0.8
    pmax: float = 1.0  # RED marking prob at kmax

    # --- transport --------------------------------------------------------
    max_msg_pkts: int = 4096  # bitmap width (max message size in packets)
    ack_coalesce: int = 1  # n:1 ACK coalescing (paper §4.5.1)
    trimming: bool = False  # paper's main runs use RTO only (App. A)
    max_cwnd_pkts: int = 170  # 2 BDP
    init_cwnd_pkts: int = 85  # 1 BDP

    # --- congestion control -----------------------------------------------
    cc: str = "dctcp"  # dctcp | eqds | delay
    dctcp_g: float = 1.0 / 16.0
    delay_target_ticks: int = 64
    delay_beta: float = 0.5

    # --- load balancing ---------------------------------------------------
    evs_size: int = 65536

    # --- engine sizing ----------------------------------------------------
    pkt_slots: int = 0  # 0 = auto (n_conns * max_cwnd + slack)
    # scale mode: the sparse active set and the lifetime-sized packet table
    # (engine.py); active_slots pins the set's size A (0 = the lifetime
    # bound); SweepEngine(conn_devices=N) also splits the connection axis
    # over N ranks.
    conn_sharding: bool = False
    active_slots: int = 0
    # shape pins of the reference's sweep bucketing (0 = derive from the
    # workload); kept so a pinned configuration sizes the same in both.
    msg_slots: int = 0
    conns_per_host: int = 0
    failure_slots: int = 0
    feedback_rounds: int = 2  # exact per-conn events applied per tick
    n_watch_queues: int = 16  # queues traced per tick for micro figures
    # kept for parity with the reference's fields; "auto" only (the device
    # picks kernels or plain versions, see the module docstring)
    arrivals_backend: str = "auto"
    kernels_backend: str = "auto"

    def __post_init__(self):
        for name in ("arrivals_backend", "kernels_backend"):
            if getattr(self, name) not in BACKENDS:
                raise ValueError(
                    f"{name}={getattr(self, name)!r}: the port accepts only 'auto'; "
                    "the device picks the path (kernels on CUDA, plain versions on the CPU)"
                )

    # derived topology -----------------------------------------------------
    @property
    def n_tors(self) -> int:
        return self.n_hosts // self.hosts_per_tor

    @property
    def n_pods(self) -> int:
        assert self.tiers == 3
        return self.n_tors // self.tors_per_pod

    @property
    def n_spines(self) -> int:
        assert self.tiers == 2
        return self.uplinks_per_tor

    @property
    def n_cores(self) -> int:
        assert self.tiers == 3
        return self.aggs_per_pod * self.agg_uplinks

    @property
    def kmin(self) -> int:
        return max(1, int(self.queue_capacity * self.kmin_frac))

    @property
    def kmax(self) -> int:
        return max(2, int(self.queue_capacity * self.kmax_frac))

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
