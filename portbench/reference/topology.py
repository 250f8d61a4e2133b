# Frozen copy of the port's plain formulation (src/repro_torch/netsim/topology.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""Fat-tree topology: queue-id layout, ECMP hashing and the hop-transition
function (counterpart of ``repro.netsim.topology``).

Every directed link has one FIFO queue at its source.  Queue-id regions:

2-tier (T tors × H hosts each, U uplinks == U spines):
    t0_up[t, u]   = t*U + u                         [0,            T*U)
    sp_down[s, t] = T*U + s*T + t                   [T*U,          T*U+U*T)
    t0_down[t, h] = T*U + U*T + t*H + h             [...,          +T*H)

3-tier (P pods × Tp tors × H hosts; A aggs/pod; U2 core-uplinks/agg;
        C = A*U2 cores; core c attaches to agg c//U2 of every pod):
    t0_up[t, a]        = t*A + a
    agg_up[p, a, u]    = T*A + (p*A + a)*U2 + u
    core_down[c, p]    = T*A + P*A*U2 + c*P + p
    agg_down[p, a, tl] = ... + C*P + (p*A + a)*Tp + tl
    t0_down[t, h]      = ... + P*A*Tp + t*H + h

The packet's EV selects the up-direction port through a mixing hash of
(flow id, EV, switch salt); down-direction ports follow the destination.
The whole hop transition is one kernel, ``next_queue`` (its plain version
``kernels.ref.next_queue_ref``), reached through ``Topology.next_queue``
(the reference's signature) and ``Topology.route`` (the engine's arrivals).
``ecmp_hash`` is the flat hash kernel, ``mix32`` and ``ecmp_hash_np`` the
hash's finalizer on tensors and its Python-int mirror for host-side walks.

A generated fabric (``cfg.fabric``, ``netsim/topogen.py``) builds a
``TableTopology`` instead: the same interface over the spec's tables, its
routing step the ``next_queue_table`` kernel (one launch per tick for every
fabric kind; plain version ``kernels.ref.next_queue_table_ref``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ops as kernel_ops
from .kshapes import RouteGeometry
from .kshapes import RouteTables
from .ref import mix32  # noqa: F401  (re-exported)
from .config import SimConfig
from .rng import M32


# the ECMP hash: the ``ecmp_hash`` kernel on a CUDA tensor, its plain
# version on a CPU tensor
ecmp_hash = kernel_ops.ecmp_hash


def _mix32_np(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return x


def ecmp_hash_np(flow_id: int, ev: int, salt: int, nports: int) -> int:
    """Python-int mirror of ``ecmp_hash`` for host-side walks."""
    h = _mix32_np(
        ((flow_id * 0x9E3779B1) ^ (ev * 0x85EBCA77) ^ (salt * 0xC2B2AE3D)) & M32
    )
    return int(h % max(int(nports), 1))


@dataclasses.dataclass(frozen=True)
class Topology:
    cfg: SimConfig
    n_queues: int
    # region bases (python ints)
    t0_up_base: int
    agg_up_base: int  # 3-tier only (== -1 for 2-tier)
    core_down_base: int
    agg_down_base: int
    t0_down_base: int
    geometry: RouteGeometry  # the layout as the routing kernel takes it

    @staticmethod
    def build(cfg: SimConfig) -> "Topology":
        if cfg.fabric:
            # a generated fabric: the same interface, one table-driven router
            # for every fabric kind
            return TableTopology.build(cfg)
        T, H = cfg.n_tors, cfg.hosts_per_tor
        if cfg.tiers == 2:
            U = cfg.uplinks_per_tor
            sp_down = T * U
            t0_down = sp_down + U * T
            nq = t0_down + T * H
            return Topology(
                cfg=cfg, n_queues=nq, t0_up_base=0, agg_up_base=-1, core_down_base=sp_down,
                agg_down_base=-1, t0_down_base=t0_down,
                geometry=RouteGeometry(2, H, T, U, 0, 0, 0, 0, 0, -1, sp_down, -1, t0_down, nq),
            )
        A, U2, P, Tp = cfg.aggs_per_pod, cfg.agg_uplinks, cfg.n_pods, cfg.tors_per_pod
        agg_up = T * A
        core_down = agg_up + P * A * U2
        agg_down = core_down + cfg.n_cores * P
        t0_down = agg_down + P * A * Tp
        nq = t0_down + T * H
        return Topology(
            cfg=cfg, n_queues=nq, t0_up_base=0, agg_up_base=agg_up, core_down_base=core_down,
            agg_down_base=agg_down, t0_down_base=t0_down,
            geometry=RouteGeometry(3, H, T, 0, A, U2, Tp, P, 0, agg_up, core_down, agg_down,
                                   t0_down, nq),
        )

    @property
    def diameter(self) -> int:
        """Max queue hops on any src->dst path (host downlink included)."""
        return 3 if self.cfg.tiers == 2 else 5

    # -- host-side helpers ------------------------------------------------
    def t0_up_queues(self, tor: int) -> np.ndarray:
        cfg = self.cfg
        n_up = cfg.uplinks_per_tor if cfg.tiers == 2 else cfg.aggs_per_pod
        return np.arange(n_up) + self.t0_up_base + tor * n_up

    def t0_down_queue(self, host: int) -> int:
        cfg = self.cfg
        t, hl = host // cfg.hosts_per_tor, host % cfg.hosts_per_tor
        return self.t0_down_base + t * cfg.hosts_per_tor + hl

    def is_final_hop(self, q: torch.Tensor) -> torch.Tensor:
        return q >= self.t0_down_base

    # -- the hop-transition function: the ``next_queue`` kernel ----------
    def next_queue(
        self,
        at_injection: torch.Tensor,  # bool (K,): packet leaving the source host
        cur_queue: torch.Tensor,  # int32 (K,): queue just dequeued from
        flow_id: torch.Tensor,  # int32 (K,)
        ev: torch.Tensor,  # int32 (K,)
        src: torch.Tensor,  # int32 (K,) source host id
        dst: torch.Tensor,  # int32 (K,) destination host id
        q_len: torch.Tensor,  # int32 (n_queues,): lengths (adaptive only)
        adaptive: bool,  # in-network least-queue choice
    ) -> torch.Tensor:
        return kernel_ops.next_queue(
            self.geometry, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive)

    def route(
        self,
        a_idx: torch.Tensor,  # int32 (B, K) or (K,): packet slot of each arrival, >= n_pkt: none
        n_pkt: int,
        hop: torch.Tensor,  # int32, like a_idx, gathered packet rows: hops so far (0: injection)
        cur_queue: torch.Tensor,  # queue just dequeued from (-1 at injection)
        conn: torch.Tensor,  # connection (the hash's flow id)
        ev: torch.Tensor,  # entropy value
        conn_src: torch.Tensor,  # int32 (NC,) connection -> source host, or (B, NC) per row
        conn_dst: torch.Tensor,  # int32, like conn_src: connection -> destination host
        q_len: torch.Tensor,  # int32 (B, n_queues) or (n_queues,)
        q_penalty: torch.Tensor | None,  # int32 (n_queues,) or (B, n_queues): added to q_len
        adaptive: bool,
    ) -> torch.Tensor:
        """The engine's arrivals, of one run or of every row of a fleet:
        each arrival's next queue, ``n_queues`` for the empty slots, in one
        launch."""
        return kernel_ops.next_queue(
            self.geometry, hop, cur_queue, conn, ev, conn_src, conn_dst, q_len, adaptive,
            q_penalty=q_penalty, a_idx=a_idx, n_pkt=n_pkt)


class TableTopology:
    """Table-driven topology of a generated ``TopologySpec``
    (``netsim/topogen.py``), with the interface of ``Topology`` (``n_queues``,
    ``t0_down_base``, ``diameter``, ``t0_up_queues``, ``t0_down_queue``,
    ``is_final_hop``, ``next_queue``, ``route``), so that the engine, the
    fleet and the sweep run generated fabrics with no special case.

    Routing is one up/down rule over the spec's tables: down through
    ``down_next[sw, dst]`` when it is defined, else over the ``up_deg[sw]``
    queues from ``up_base[sw, dst]``, by the ECMP hash of (flow, EV, the
    switch's salt plane) or, under an adaptive LB, the first least-loaded.
    The tables are uploaded once per device (``tables``)."""

    def __init__(self, cfg: SimConfig, spec):
        if spec.n_hosts != cfg.n_hosts:
            raise ValueError(
                f"fabric {cfg.fabric!r} has {spec.n_hosts} hosts but "
                f"SimConfig.n_hosts={cfg.n_hosts}; they must agree"
            )
        self.cfg = cfg
        self.spec = spec
        self.n_queues = spec.n_queues
        self.t0_down_base = spec.t0_down_base
        # region bases kept for the interface (the router does not use them)
        self.t0_up_base = 0
        self.agg_up_base = -1
        self.core_down_base = -1
        self.agg_down_base = -1
        self._tables: dict[torch.device, RouteTables] = {}

    @staticmethod
    def build(cfg: SimConfig) -> "TableTopology":
        raise NotImplementedError("the reference runs one rank on the arithmetic fat tree")

        return TableTopology(cfg, build_spec(cfg.fabric))

    @property
    def diameter(self) -> int:
        """Max queue hops on any src->dst path (host downlink included)."""
        return self.spec.diameter

    def tables(self, device) -> RouteTables:
        """The spec's routing tables as int32 tensors on ``device``, made once
        per device."""
        dev = torch.device(device)
        t = self._tables.get(dev)
        if t is None:
            sp = self.spec
            up = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)
            t = self._tables[dev] = RouteTables(
                host_sw=up(sp.host_sw), q_sw=up(sp.q_sw), up_base=up(sp.up_base),
                up_deg=up(sp.up_deg), down_next=up(sp.down_next), salt=up(sp.salt),
                max_up_deg=max(sp.max_up_deg, 1))
        return t

    # -- host-side helpers ------------------------------------------------
    def t0_up_queues(self, tor: int) -> np.ndarray:
        base, size = (int(v) for v in self.spec.sw_up_span[tor])
        return np.arange(size) + base

    def t0_down_queue(self, host: int) -> int:
        return self.t0_down_base + host

    def is_final_hop(self, q: torch.Tensor) -> torch.Tensor:
        return q >= self.t0_down_base

    # -- the hop-transition function: the ``next_queue_table`` kernel -----
    def next_queue(self, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                   adaptive: bool) -> torch.Tensor:
        """``Topology.next_queue``'s signature and arguments."""
        return kernel_ops.next_queue_table(
            self.tables(cur_queue.device), at_injection, cur_queue, flow_id, ev, src, dst,
            q_len, adaptive)

    def route(self, a_idx, n_pkt: int, hop, cur_queue, conn, ev, conn_src, conn_dst, q_len,
              q_penalty, adaptive: bool) -> torch.Tensor:
        """``Topology.route``'s signature and arguments: the engine's
        arrivals, of one run or of a fleet's rows, in one launch."""
        return kernel_ops.next_queue_table(
            self.tables(q_len.device), hop, cur_queue, conn, ev, conn_src, conn_dst, q_len,
            adaptive, q_penalty=q_penalty, a_idx=a_idx, n_pkt=n_pkt)
