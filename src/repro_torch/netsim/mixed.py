"""MixedLB: two load balancers side by side in one simulation (foreground
vs background traffic, paper Fig. 5 / incremental deployment); counterpart
of ``repro.netsim.mixed``.

Each connection is statically assigned to cohort A or B; state for both LBs
is kept and events are routed by the cohort mask.  The cohort is given
either as a boolean mask over the workload's connections or as a tuple of
background conn indices (``bg_conns``); the mask itself is built in
``init_state`` at the engine's conn-table width.  Every draw splits its key
in two, one half per cohort, as the reference does per call.

Registered as ``make_lb("mixed", fg=..., bg=..., bg_conns=(...))`` with the
reference's hashable keyword arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.load_balancers import REGISTRY, LoadBalancer, make_lb


class MixedLB(LoadBalancer):
    name = "mixed"

    def __init__(
        self,
        lb_a: LoadBalancer,
        lb_b: LoadBalancer,
        b_mask: np.ndarray | None = None,
        bg_conns: tuple[int, ...] | None = None,
    ):
        super().__init__(lb_a.evs_size)
        if lb_a.switch_adaptive or lb_b.switch_adaptive:
            raise ValueError("mixed mode supports endpoint LBs only")
        if (b_mask is None) == (bg_conns is None):
            raise ValueError("pass exactly one of b_mask / bg_conns")
        if b_mask is not None:
            bg_conns = tuple(int(i) for i in np.nonzero(np.asarray(b_mask, bool))[0])
        self.lb_a, self.lb_b = lb_a, lb_b
        self.bg_conns = tuple(int(i) for i in bg_conns)
        self.name = f"mixed({lb_a.name}+{lb_b.name})"

    def _mask(self, n_conns: int) -> np.ndarray:
        bm = np.zeros((n_conns,), bool)
        if self.bg_conns:
            bm[list(self.bg_conns)] = True
        return bm

    def init_state(self, n_conns, key):
        ks = rng.split(key)
        return (
            self.lb_a.init_state(n_conns, ks[0]),
            self.lb_b.init_state(n_conns, ks[1]),
            torch.as_tensor(self._mask(n_conns), device=key.device),
        )

    def _split_draw(self, fn_a, fn_b, keys, n_conns):
        ks = rng.split(keys)  # (..., 2, 2): one key per cohort
        return (fn_a(ks[..., 0, :], n_conns), fn_b(ks[..., 1, :], n_conns))

    def draw(self, keys, n_conns):
        return self._split_draw(self.lb_a.draw, self.lb_b.draw, keys, n_conns)

    def draw_ack(self, keys, n_conns):
        return self._split_draw(self.lb_a.draw_ack, self.lb_b.draw_ack, keys, n_conns)

    def draw_timeout(self, keys, n_conns):
        return self._split_draw(self.lb_a.draw_timeout, self.lb_b.draw_timeout, keys, n_conns)

    def choose_ev(self, state, mask, draw, now):
        sa, sb, bm = state
        ev_a, sa = self.lb_a.choose_ev(sa, mask & ~bm, draw[0], now)
        ev_b, sb = self.lb_b.choose_ev(sb, mask & bm, draw[1], now)
        return torch.where(bm, ev_b, ev_a), (sa, sb, bm)

    def on_ack(self, state, mask, ev, ecn, now, draw):
        sa, sb, bm = state
        sa = self.lb_a.on_ack(sa, mask & ~bm, ev, ecn, now, draw[0])
        sb = self.lb_b.on_ack(sb, mask & bm, ev, ecn, now, draw[1])
        return (sa, sb, bm)

    def on_timeout(self, state, mask, now, draw):
        sa, sb, bm = state
        sa = self.lb_a.on_timeout(sa, mask & ~bm, now, draw[0])
        sb = self.lb_b.on_timeout(sb, mask & bm, now, draw[1])
        return (sa, sb, bm)

    @property
    def trace_sites(self):
        return self.lb_a.trace_sites | self.lb_b.trace_sites

    def trace(self, site, prev, new, mask, rows=1):
        bm = new[2]
        return (self.lb_a.trace(site, prev[0], new[0], mask & ~bm, rows)
                + self.lb_b.trace(site, prev[1], new[1], mask & bm, rows))

    def step(self, state, acks, timeout_mask, send_mask, draws, now, rows=None):
        sa, sb, bm = state
        am = ~bm
        td, sd = draws
        ev_a, sa, *ca = self.lb_a.step(
            sa, [(m & am, ev, ecn, d[0]) for m, ev, ecn, d in acks], timeout_mask & am,
            send_mask & am, (td[0], sd[0]), now, rows)
        ev_b, sb, *cb = self.lb_b.step(
            sb, [(m & bm, ev, ecn, d[1]) for m, ev, ecn, d in acks], timeout_mask & bm,
            send_mask & bm, (td[1], sd[1]), now, rows)
        out = torch.where(bm, ev_b, ev_a), (sa, sb, bm)
        return out if rows is None else (*out, ca[0] + cb[0])


def _make_mixed(
    fg: str = "ops",
    bg: str = "ecmp",
    bg_conns: tuple[int, ...] = (),
    evs_size: int = 65536,
) -> MixedLB:
    """Registry entry: a hashable-kwargs constructor."""
    return MixedLB(
        make_lb(fg, evs_size=evs_size),
        make_lb(bg, evs_size=evs_size),
        bg_conns=tuple(bg_conns),
    )


REGISTRY["mixed"] = _make_mixed
