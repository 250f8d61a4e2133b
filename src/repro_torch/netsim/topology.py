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
(flow id, EV, switch salt) — the ``ecmp_hash`` kernel, one launch per hash
site; down-direction ports follow the destination.  ``mix32`` and
``ecmp_hash_np`` are the hash's finalizer on tensors and its Python-int
mirror for host-side walks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import mix32  # noqa: F401  (re-exported)
from repro_torch.netsim.config import SimConfig
from repro_torch.rng import M32


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

    @staticmethod
    def build(cfg: SimConfig) -> "Topology":
        if cfg.fabric:
            raise NotImplementedError(
                f"generated fabric {cfg.fabric!r}: TableTopology is not ported "
                "yet (see ROADMAP.md, queue 1 item 12)"
            )
        T, H = cfg.n_tors, cfg.hosts_per_tor
        if cfg.tiers == 2:
            U = cfg.uplinks_per_tor
            sp_down = T * U
            t0_down = sp_down + U * T
            return Topology(
                cfg=cfg, n_queues=t0_down + T * H, t0_up_base=0,
                agg_up_base=-1, core_down_base=sp_down, agg_down_base=-1,
                t0_down_base=t0_down,
            )
        A, U2, P, Tp = cfg.aggs_per_pod, cfg.agg_uplinks, cfg.n_pods, cfg.tors_per_pod
        agg_up = T * A
        core_down = agg_up + P * A * U2
        agg_down = core_down + cfg.n_cores * P
        t0_down = agg_down + P * A * Tp
        return Topology(
            cfg=cfg, n_queues=t0_down + T * H, t0_up_base=0,
            agg_up_base=agg_up, core_down_base=core_down,
            agg_down_base=agg_down, t0_down_base=t0_down,
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

    # -- the hop-transition function ----------------------------------------
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
        cfg = self.cfg
        T, H = cfg.n_tors, cfg.hosts_per_tor
        dev = cur_queue.device
        src_tor, dst_tor = src // H, dst // H
        dst_local = dst % H
        same_tor = src_tor == dst_tor
        t0_down = self.t0_down_base + dst_tor * H + dst_local

        def least_queue(base, n):  # first least-loaded of n candidate ports
            cand = base[:, None] + torch.arange(n, dtype=torch.int32, device=dev)
            return torch.argmin(q_len[cand.long()], dim=1).to(torch.int32)

        if cfg.tiers == 2:
            U = cfg.uplinks_per_tor
            if adaptive:  # the reference hashes, then overrides: no launch here
                up_choice = least_queue(self.t0_up_base + src_tor * U, U)
            else:
                up_choice = kernel_ops.ecmp_hash(flow_id, ev, src_tor, U)
            t0_up = self.t0_up_base + src_tor * U + up_choice
            at_t0_up = cur_queue < self.core_down_base
            spine = torch.where(at_t0_up, cur_queue - self.t0_up_base, 0) % U
            sp_down = self.core_down_base + spine * T + dst_tor
            nxt = torch.where(
                at_injection,
                torch.where(same_tor, t0_down, t0_up),
                torch.where(at_t0_up, sp_down, t0_down),
            )
            return nxt.to(torch.int32)

        # ---- 3-tier ----
        A, U2, Tp, P = cfg.aggs_per_pod, cfg.agg_uplinks, cfg.tors_per_pod, cfg.n_pods
        src_pod, dst_pod = src_tor // Tp, dst_tor // Tp
        dst_tor_local = dst_tor % Tp
        same_pod = src_pod == dst_pod

        if adaptive:
            up1 = least_queue(self.t0_up_base + src_tor * A, A)
        else:
            up1 = kernel_ops.ecmp_hash(flow_id, ev, src_tor, A)
        t0_up = self.t0_up_base + src_tor * A + up1

        in_t0_up = cur_queue < self.agg_up_base
        agg_a = torch.where(in_t0_up, cur_queue - self.t0_up_base, 0) % A
        agg_global = src_pod * A + agg_a
        if adaptive:
            up2 = least_queue(self.agg_up_base + agg_global * U2, U2)
        else:
            up2 = kernel_ops.ecmp_hash(flow_id, ev, agg_global + 7919, U2)
        agg_up = self.agg_up_base + agg_global * U2 + up2
        agg_down_same = self.agg_down_base + agg_global * Tp + dst_tor_local

        in_agg_up = (cur_queue >= self.agg_up_base) & (cur_queue < self.core_down_base)
        rel = torch.where(in_agg_up, cur_queue - self.agg_up_base, 0)
        core = (rel // U2 % A) * U2 + rel % U2  # (p*A+a)*U2+u -> c = a*U2+u
        core_down = self.core_down_base + core * P + dst_pod

        in_core_down = (cur_queue >= self.core_down_base) & (cur_queue < self.agg_down_base)
        core_at = torch.where(in_core_down, cur_queue - self.core_down_base, 0) // P
        dst_agg = core_at // U2
        agg_down_x = self.agg_down_base + (dst_pod * A + dst_agg) * Tp + dst_tor_local

        nxt = torch.where(
            at_injection,
            torch.where(same_tor, t0_down, t0_up),
            torch.where(
                in_t0_up,
                torch.where(same_pod, agg_down_same, agg_up),
                torch.where(
                    in_agg_up,
                    core_down,
                    torch.where(in_core_down, agg_down_x, t0_down),
                ),
            ),
        )
        return nxt.to(torch.int32)
