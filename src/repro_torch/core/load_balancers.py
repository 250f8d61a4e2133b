"""The load balancers that carry the paper's claim — ECMP, OPS and REPS —
behind one interface (counterpart of ``repro.core.load_balancers``).

Each load balancer is a static object holding configuration; its mutable
per-connection state is a tensor or a small dataclass of tensors that the
engine threads through the tick:

    init_state(n_conns, key)                  -> state (on key's device)
    draw(keys, n_conns)                       -> (T, n_conns) draws or None
    choose_ev(state, mask, draw, now)         -> (evs (N,), state)
    on_ack(state, mask, ev, ecn, now, key)    -> state
    on_timeout(state, mask, now, key)         -> state

``mask`` selects the connections that send / got an ACK / timed out this
tick.  Keys follow the reference's key-threading contract: the tick key
folded with 2 for sending, ``fold_in(fold_in(tick_key, 4), round)`` per
feedback round for ``on_ack`` and 5 for ``on_timeout``.

One change of shape from the reference: there ``choose_ev`` takes the
fold-2 key and draws from it.  A counter-based draw depends only on the
key, never on the state, so here the draw is split out: ``draw`` makes it
for a whole chunk of ticks at once from their fold-2 keys (bit-equal, row
by row, to what the reference draws tick by tick), and ``choose_ev``
receives this tick's row.  That keeps the random number generator out of
the tick's launch count.

The rest of the reference's zoo (PLB, flowlet, MPTCP, MPRDMA, bitmap,
adaptive RoCE, Prime, SeqBalance, flowlet table, the switch and mixed
wrappers) and the flight recorder's ``trace`` port are later slices.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.core import reps as reps_core
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.reps_update import BUF as KERNEL_BUF


class LoadBalancer:
    name: str = "abstract"
    switch_adaptive: bool = False

    def __init__(self, evs_size: int = 65536):
        self.evs_size = evs_size

    def init_state(self, n_conns: int, key: torch.Tensor):
        raise NotImplementedError

    def draw(self, keys: torch.Tensor, n_conns: int):
        """The randomness ``choose_ev`` takes from its fold-2 key, for the
        ``(T, 2)`` keys of T ticks at once; ``None`` if it draws nothing."""
        return None

    def choose_ev(self, state, mask, draw, now):
        raise NotImplementedError

    def on_ack(self, state, mask, ev, ecn, now, key):
        return state

    def on_timeout(self, state, mask, now, key):
        return state


def _rand_evs(keys: torch.Tensor, n: int, evs_size: int) -> torch.Tensor:
    return rng.randint(keys, (n,), 0, evs_size)


# ---------------------------------------------------------------------------
# ECMP: one static EV per connection (per-flow hashing).  §2.2
# ---------------------------------------------------------------------------
class EcmpLB(LoadBalancer):
    name = "ecmp"

    def init_state(self, n_conns, key):
        return _rand_evs(key, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        return state, state


# ---------------------------------------------------------------------------
# OPS: uniform random EV per packet.  §2.2
# ---------------------------------------------------------------------------
class OpsLB(LoadBalancer):
    name = "ops"

    def init_state(self, n_conns, key):
        # placeholder state, as in the reference
        return torch.zeros((n_conns,), dtype=torch.int32, device=key.device)

    def draw(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        return draw, state


# ---------------------------------------------------------------------------
# REPS (the paper).  §3
# ---------------------------------------------------------------------------
class RepsLB(LoadBalancer):
    """REPS with a switchable compute backend.

    backend="torch" — the tensor formulation in ``repro_torch.core.reps``;
    backend="cuda"  — the fused ``reps_tick`` kernel drives Algorithms 1+2
                      (its wrapper runs the kernel's plain version when the
                      state lies on the CPU);
    backend="auto"  — "cuda" when the state is on a CUDA device, else
                      "torch".

    Both share ``REPSState`` and are bit-identical.  The kernel is compiled
    for the paper's 8-deep ring: where it would run ("cuda", or "auto" on a
    CUDA device) another ``buffer_size`` raises rather than stepping REPS on
    the card without it.
    """

    name = "reps"

    def __init__(
        self,
        evs_size: int = 65536,
        buffer_size: int = 8,
        num_pkts_bdp: int = 32,
        freezing_timeout: int = 1024,
        enable_freezing: bool = True,
        backend: str = "auto",
    ):
        super().__init__(evs_size)
        self.cfg = reps_core.REPSConfig(
            buffer_size=buffer_size,
            evs_size=evs_size,
            num_pkts_bdp=num_pkts_bdp,
            freezing_timeout=freezing_timeout,
        )
        self.enable_freezing = enable_freezing
        if backend not in ("auto", "torch", "cuda"):
            raise ValueError(f"unknown RepsLB backend {backend!r}")
        self.backend = backend
        if backend == "cuda":
            self.uses_kernel(torch.device("cuda"))

    def uses_kernel(self, device) -> bool:
        """Whether state on ``device`` steps through the ``reps_tick``
        kernel's wrapper; raises if it would but the ring is not the
        kernel's depth."""
        use = self.backend == "cuda" or (
            self.backend == "auto" and torch.device(device).type == "cuda"
        )
        if use and self.cfg.buffer_size != KERNEL_BUF:
            raise ValueError(
                f"the reps_tick kernel is compiled for buffer depth {KERNEL_BUF}, "
                f"got {self.cfg.buffer_size}"
            )
        return use

    def _use_kernel(self, state: reps_core.REPSState) -> bool:
        return self.uses_kernel(state.head.device)

    def init_state(self, n_conns, key):
        self.uses_kernel(key.device)
        return reps_core.init_state(self.cfg, n_conns, device=key.device)

    def draw(self, keys, n_conns):
        return reps_core.draw_evs(self.cfg, keys, n_conns)

    def _kernel_tick(self, state, now, ack_mask=None, ack_ev=None, ack_ecn=None,
                     timeout_mask=None, send_mask=None, rand_ev=None):
        """One fused Algorithm 1+2 pass; event classes left out are no-ops,
        so each engine stage (feedback / RTO / injection) is one launch."""
        out = kernel_ops.reps_tick(
            state.buf_ev, state.buf_valid, state.head, state.num_valid,
            state.explore_counter, state.is_freezing, state.exit_freezing,
            state.n_cached, ack_mask, ack_ev, ack_ecn, timeout_mask, send_mask,
            rand_ev, now, self.cfg.num_pkts_bdp, self.cfg.freezing_timeout,
        )
        return reps_core.REPSState(*out[:8]), out[8]

    def choose_ev(self, state, mask, draw, now):
        if self._use_kernel(state):
            state, evs = self._kernel_tick(state, now, send_mask=mask, rand_ev=draw)
            return evs, state
        return reps_core.choose_ev(self.cfg, state, mask, rand_ev=draw)

    def on_ack(self, state, mask, ev, ecn, now, key):
        if self._use_kernel(state):
            return self._kernel_tick(state, now, ack_mask=mask, ack_ev=ev, ack_ecn=ecn)[0]
        return reps_core.on_ack(self.cfg, state, mask, ev, ecn, now)

    def on_timeout(self, state, mask, now, key):
        if not self.enable_freezing:
            return state
        if self._use_kernel(state):
            return self._kernel_tick(state, now, timeout_mask=mask)[0]
        return reps_core.on_failure_detection(self.cfg, state, mask, now)


REGISTRY = {cls.name: cls for cls in (EcmpLB, OpsLB, RepsLB)}


def make_lb(name: str, **kwargs) -> LoadBalancer:
    if name not in REGISTRY:
        raise ValueError(
            f"load balancer {name!r} is not ported yet (ported: {sorted(REGISTRY)}); "
            "see ROADMAP.md, queue 1 item 7, for the rest of the zoo"
        )
    return REGISTRY[name](**kwargs)
