"""Workload generators (paper §4.2), copied from ``repro.netsim.workloads``.

All generators return a ``Workload`` (static numpy connection table) for the
engine.  Message sizes are in packets (MTU = 4 KiB default).  They use the
same ``np.random.RandomState`` seeds, so a seed builds the same table in
both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.netsim.engine import Workload

KIB = 1024


def pkts(nbytes: float, mtu: int = 4 * KIB) -> int:
    return max(1, int(np.ceil(nbytes / mtu)))


# ---------------------------------------------------------------------------
# Synthetic benchmarks: incast / permutation / tornado (§4.2)
# ---------------------------------------------------------------------------
def incast(n_hosts: int, degree: int, msg_pkts: int, receiver: int = 0) -> Workload:
    senders = [h for h in range(n_hosts) if h != receiver][:degree]
    n = len(senders)
    return Workload(
        src=np.asarray(senders, np.int32),
        dst=np.full((n,), receiver, np.int32),
        msg_pkts=np.full((n,), msg_pkts, np.int32),
        start=np.zeros((n,), np.int32),
        dep=np.full((n,), -1, np.int32),
        name=f"incast{degree}",
    )


def permutation(n_hosts: int, msg_pkts: int, seed: int = 0) -> Workload:
    """Random derangement: each host sends to and receives from exactly one."""
    rng = np.random.RandomState(seed)
    while True:
        perm = rng.permutation(n_hosts)
        if not np.any(perm == np.arange(n_hosts)):
            break
    return Workload(
        src=np.arange(n_hosts, dtype=np.int32),
        dst=perm.astype(np.int32),
        msg_pkts=np.full((n_hosts,), msg_pkts, np.int32),
        start=np.zeros((n_hosts,), np.int32),
        dep=np.full((n_hosts,), -1, np.int32),
        name="permutation",
    )


def tornado(n_hosts: int, msg_pkts: int) -> Workload:
    """Each node sends to its twin in the other half of the tree (§4.2)."""
    dst = (np.arange(n_hosts) + n_hosts // 2) % n_hosts
    return Workload(
        src=np.arange(n_hosts, dtype=np.int32),
        dst=dst.astype(np.int32),
        msg_pkts=np.full((n_hosts,), msg_pkts, np.int32),
        start=np.zeros((n_hosts,), np.int32),
        dep=np.full((n_hosts,), -1, np.int32),
        name="tornado",
    )


# ---------------------------------------------------------------------------
# Datacenter traces: websearch flow-size CDF (DCTCP-style; Appendix E),
# Poisson arrivals at a target load, random receivers.
# ---------------------------------------------------------------------------
WEBSEARCH_KB = np.array(
    [1, 2, 3, 5, 7, 10, 15, 30, 50, 80, 200, 1000, 2000, 5000, 10000, 30000],
    np.float64,
)
WEBSEARCH_CDF = np.array(
    [0.10, 0.15, 0.20, 0.30, 0.40, 0.53, 0.60, 0.70, 0.80, 0.90, 0.95, 0.97,
     0.98, 0.99, 0.997, 1.0],
    np.float64,
)


def sample_websearch_kb(rng: np.random.RandomState, n: int) -> np.ndarray:
    u = rng.rand(n)
    idx = np.searchsorted(WEBSEARCH_CDF, u)
    idx = np.clip(idx, 0, len(WEBSEARCH_KB) - 1)
    lo = np.where(idx > 0, WEBSEARCH_KB[idx - 1], 0.5)
    hi = WEBSEARCH_KB[idx]
    return lo + (hi - lo) * rng.rand(n)  # interpolate within the bucket


def websearch_trace(
    n_hosts: int,
    load: float,
    duration_ticks: int,
    seed: int = 0,
    mtu: int = 4 * KIB,
    max_pkts: int = 0,
) -> Workload:
    """Per-host Poisson flow arrivals at `load` of the host link capacity.
    `max_pkts` > 0 truncates the flow-size tail (CI-scale engine caps)."""
    rng = np.random.RandomState(seed)
    mean_pkts = float(np.mean([pkts(kb * KIB, mtu) for kb in sample_websearch_kb(rng, 4096)]))
    rate = load / mean_pkts  # flows per tick per host (1 pkt/tick links)
    src, dst, msg, start = [], [], [], []
    for h in range(n_hosts):
        t = 0.0
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= duration_ticks:
                break
            d = rng.randint(n_hosts - 1)
            d = d + (d >= h)
            src.append(h)
            dst.append(d)
            size = pkts(sample_websearch_kb(rng, 1)[0] * KIB, mtu)
            msg.append(min(size, max_pkts) if max_pkts else size)
            start.append(int(t))
    n = len(src)
    return Workload(
        src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32),
        msg_pkts=np.asarray(msg, np.int32),
        start=np.asarray(start, np.int32),
        dep=np.full((n,), -1, np.int32),
        name=f"websearch{int(load * 100)}",
    )


# ---------------------------------------------------------------------------
# AI collectives (§4.2): ring / butterfly AllReduce, windowed AllToAll.
# Dependencies are expressed as conn -> prerequisite conn (engine starts a
# connection once its prerequisite completes).
# ---------------------------------------------------------------------------
def ring_allreduce(n_hosts: int, total_msg_pkts: int) -> Workload:
    """2(p-1) rounds; round r of node i depends on node i-1 finishing round
    r-1 (the chunk it forwards must have arrived)."""
    p = n_hosts
    chunk = max(1, total_msg_pkts // p)
    rounds = 2 * (p - 1)
    src, dst, msg, start, dep = [], [], [], [], []
    conn_id = {}
    for r in range(rounds):
        for i in range(p):
            conn_id[(i, r)] = len(src)
            src.append(i)
            dst.append((i + 1) % p)
            msg.append(chunk)
            start.append(0)
            dep.append(-1 if r == 0 else conn_id[((i - 1) % p, r - 1)])
    return Workload(
        src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32),
        msg_pkts=np.asarray(msg, np.int32),
        start=np.asarray(start, np.int32),
        dep=np.asarray(dep, np.int32),
        name="ring_allreduce",
    )


def butterfly_allreduce(n_hosts: int, total_msg_pkts: int) -> Workload:
    """log2(p) exchange rounds (recursive doubling); round r of node i
    depends on receiving its partner's round r-1 data."""
    p = n_hosts
    assert p & (p - 1) == 0, "butterfly needs a power-of-two host count"
    rounds = int(np.log2(p))
    per_round = max(1, total_msg_pkts // rounds)
    src, dst, msg, start, dep = [], [], [], [], []
    conn_id = {}
    for r in range(rounds):
        for i in range(p):
            partner = i ^ (1 << r)
            conn_id[(i, r)] = len(src)
            src.append(i)
            dst.append(partner)
            msg.append(per_round)
            start.append(0)
            prev_partner = i ^ (1 << (r - 1)) if r > 0 else 0
            dep.append(-1 if r == 0 else conn_id[(prev_partner, r - 1)])
    return Workload(
        src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32),
        msg_pkts=np.asarray(msg, np.int32),
        start=np.asarray(start, np.int32),
        dep=np.asarray(dep, np.int32),
        name="butterfly_allreduce",
    )


def alltoall(n_hosts: int, per_pair_pkts: int, window: int = 4, seed: int = 0) -> Workload:
    """Windowed AllToAll: each host sends to every other host in a rotated
    order with at most `window` of its connections active at once (§4.2)."""
    rng = np.random.RandomState(seed)
    src, dst, msg, start, dep = [], [], [], [], []
    for h in range(n_hosts):
        order = [(h + 1 + k) % n_hosts for k in range(n_hosts - 1)]
        rng.shuffle(order)
        ids = []
        for k, d in enumerate(order):
            ids.append(len(src))
            src.append(h)
            dst.append(d)
            msg.append(per_pair_pkts)
            start.append(0)
            dep.append(-1 if k < window else ids[k - window])
    return Workload(
        src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32),
        msg_pkts=np.asarray(msg, np.int32),
        start=np.asarray(start, np.int32),
        dep=np.asarray(dep, np.int32),
        name=f"alltoall_w{window}",
    )


# ---------------------------------------------------------------------------
# Mixed traffic (fig 5): a fraction of hosts run background ECMP flows.
# Returned as (foreground_workload, background_conn_mask); both cohorts live
# in one conn table (the reference's MixedLB assigns "ecmp" to the background
# conns; ``repro_torch.netsim.mixed``).
# ---------------------------------------------------------------------------
def permutation_with_background(
    n_hosts: int, msg_pkts: int, bg_fraction: float = 0.1, seed: int = 0
) -> tuple[Workload, np.ndarray]:
    wl = permutation(n_hosts, msg_pkts, seed)
    rng = np.random.RandomState(seed + 1)
    n_bg = max(1, int(round(bg_fraction * wl.n_conns)))
    bg = np.zeros((wl.n_conns,), bool)
    bg[rng.choice(wl.n_conns, n_bg, replace=False)] = True
    return wl, bg
