"""The benchmark's one traffic generator: a traffic file's parameters and a
seed give the arrays that both the program and the reference receive.

Frozen here so that later changes to the program cannot move the yardstick:
``permutation`` is ``repro_torch.netsim.workloads.permutation`` (NumPy's
``RandomState`` derangement), and a failure names a ToR uplink as
``chip_smoke.py``'s ``fig06_scenario`` does (ToR-0 uplinks 0 and 1 down over
two windows).

A run is a queue of batches.  Batch ``b`` of seed ``s`` draws its workload
seed and its rows' seeds from ``SeedSequence([s, b])``; every batch has the
same sizes, arrivals and failure windows, so seeds change which hosts pair
up and which random draws the rows make, never how much work there is.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.config import SimConfig
from portbench.reference.topology import Topology

SEED_MOD = 2**64  # SeedSequence takes any whole number >= 0
ROW_SEED_MAX = 2**31  # the simulator's PRNGKey takes a 31-bit seed


@dataclasses.dataclass
class Batch:
    """One batch of a cell: the connection table, the failure windows, the
    watched queues, the load balancers and one ``(lb index, seed)`` per row."""
    src: np.ndarray
    dst: np.ndarray
    msg_pkts: np.ndarray
    start: np.ndarray
    dep: np.ndarray
    f_queue: np.ndarray
    f_start: np.ndarray
    f_end: np.ndarray
    f_kind: np.ndarray
    watch: np.ndarray
    lbs: list  # [(name, kwargs)]
    rows: list  # [(lb index, row seed)], in the bucket's row order
    horizon: int
    collect: str
    name: str


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % SEED_MOD, *tags]))


def permutation(n_hosts: int, msg_pkts: int, seed: int):
    """Random derangement: each host sends to and receives from exactly one."""
    rng = np.random.RandomState(seed)
    while True:
        perm = rng.permutation(n_hosts)
        if not np.any(perm == np.arange(n_hosts)):
            break
    n = n_hosts
    return (np.arange(n, dtype=np.int32), perm.astype(np.int32), np.full(n, msg_pkts, np.int32),
            np.zeros(n, np.int32), np.full(n, -1, np.int32))


def make_batch(fabric: dict, traffic: dict, seed: int, batch: int) -> Batch:
    """Batch ``batch`` of a run seeded ``seed`` under the traffic file's
    parameters on the configuration's fabric."""
    cfg = SimConfig(**fabric)
    rng = _rng(seed, batch)
    wl_seed = int(rng.integers(ROW_SEED_MAX))
    row_seeds = [int(s) for s in rng.integers(0, ROW_SEED_MAX, size=int(traffic["seeds_per_lb"]))]
    kind = traffic["pattern"]
    if kind == "permutation":
        conns = permutation(cfg.n_hosts, int(traffic["msg_pkts"]), wl_seed)
    else:
        raise ValueError(f"unknown traffic pattern {kind!r}")
    topo = Topology.build(cfg)
    fails = traffic.get("failures", [])
    f_queue = np.asarray([int(topo.t0_up_queues(f["tor"])[f["uplink"]]) for f in fails], np.int32)
    lbs = [(lb["name"], dict(lb.get("kwargs", {}))) for lb in traffic["lbs"]]
    return Batch(
        *conns,
        f_queue=f_queue,
        f_start=np.asarray([f["start"] for f in fails], np.int32),
        f_end=np.asarray([f["end"] for f in fails], np.int32),
        f_kind=np.zeros(len(fails), np.int32),
        watch=np.asarray(topo.t0_up_queues(0)[: cfg.n_watch_queues], np.int32),
        lbs=lbs,
        rows=[(i, s) for i in range(len(lbs)) for s in row_seeds],
        horizon=int(traffic["horizon"]),
        collect=traffic["collect"],
        name=f"{kind}-b{batch}",
    )


def sample_rows(n_rows: int, k: int, seed: int, batch: int) -> list[int]:
    """``k`` rows drawn from the seed, one from each of ``k`` equal strata of
    the batch (so every load balancer's block and both halves are seen)."""
    k = max(1, min(k, n_rows))
    rng = _rng(seed, batch, 1)
    edges = np.linspace(0, n_rows, k + 1).astype(np.int64)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]
