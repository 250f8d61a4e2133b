"""The constants and shape types that the port's kernel wrappers define and
its plain formulation uses, copied from ``src/repro_torch/kernels/``
(``reps_update.py``, ``queue_tick.py``, ``next_queue.py``,
``next_queue_table.py``, ``ecmp_hash.py``) without the CUDA calls."""
from __future__ import annotations

from typing import NamedTuple

import torch

BUF = 8  # REPS's EV ring depth
MAX_ROUNDS = 4  # ACK rounds one REPS update takes
N_TRACE_KINDS = 8
TR_EV_HIT, TR_EV_MISS, TR_EV_RECYCLE, TR_EV_FREEZE = 0, 1, 2, 3
TILE = 128  # queue_tick's arrivals per tile; part of the result


def ack_rounds(ack_mask, ack_ev, ack_ecn) -> tuple:
    """The ACK event classes as a tuple of R ``(mask, ev, ecn)`` rounds."""
    cols = [x if isinstance(x, (tuple, list)) else None if x is None else (x,)
            for x in (ack_mask, ack_ev, ack_ecn)]
    lengths = {len(c) for c in cols if c is not None}
    if len(lengths) > 1:
        raise ValueError(f"ACK masks, EVs and ECN flags disagree on the rounds: {sorted(lengths)}")
    R = lengths.pop() if lengths else 1
    return tuple(zip(*(c if c is not None else (None,) * R for c in cols)))


class RouteGeometry(NamedTuple):
    """The fabric's queue-id layout in plain ints; unused tiers' fields 0."""
    tiers: int
    hosts_per_tor: int
    n_tors: int
    uplinks_per_tor: int
    aggs_per_pod: int
    agg_uplinks: int
    tors_per_pod: int
    n_pods: int
    t0_up_base: int
    agg_up_base: int
    core_down_base: int
    agg_down_base: int
    t0_down_base: int
    n_queues: int


def check_geometry(g: RouteGeometry) -> RouteGeometry:
    if not isinstance(g, RouteGeometry):
        raise TypeError(f"next_queue needs a RouteGeometry, got {type(g).__name__}")
    divisors = {2: ("hosts_per_tor", "uplinks_per_tor"),
                3: ("hosts_per_tor", "aggs_per_pod", "agg_uplinks", "tors_per_pod", "n_pods")}
    if g.tiers not in divisors:
        raise ValueError(f"next_queue routes 2- and 3-tier fabrics, got tiers={g.tiers}")
    small = [f for f in divisors[g.tiers] if getattr(g, f) < 1]
    if small:
        raise ValueError(f"next_queue needs {', '.join(small)} >= 1, got {g}")
    return g


class RouteTables(NamedTuple):
    """A generated fabric's routing tables (unused by the benchmark's fabrics)."""
    host_sw: torch.Tensor
    q_sw: torch.Tensor
    up_base: torch.Tensor
    up_deg: torch.Tensor
    down_next: torch.Tensor
    salt: torch.Tensor
    max_up_deg: int

    @property
    def n_hosts(self) -> int:
        return self.host_sw.shape[0]

    @property
    def n_queues(self) -> int:
        return self.q_sw.shape[0]

    @property
    def n_switches(self) -> int:
        return self.up_deg.shape[0]


def check_nports(nports):
    if isinstance(nports, torch.Tensor) and nports.dim() > 0:
        if nports.dtype.is_floating_point or nports.dtype is torch.bool:
            raise TypeError(f"ecmp_hash: per-lane nports must be an integer tensor, "
                            f"got {nports.dtype}")
        return nports
    nports = int(nports)
    if nports < 1:
        raise ValueError(f"ecmp_hash needs nports >= 1, got {nports}")
    return nports
