"""Failure-schedule builders (paper §4.3.3, Appendix D.3), copied from
``repro.netsim.failures`` (the random builders keep their ``RandomState``
seeds, so both packages build the same schedules).

Padding/truncation semantics (shared with the sweep packer): a schedule may
be *padded* with inert rows (``FailureSchedule.pad_to``) or *truncated* by
dropping rows that provably never activate before a horizon
(``truncate_dead``) — never by clipping a window's ``end``, which would
resurrect the link at the clip boundary.  Permanent events use ``FOREVER``
as their end tick.
"""
from __future__ import annotations

import numpy as np

from repro_torch.netsim import engine
from repro_torch.netsim.config import SimConfig
from repro_torch.netsim.engine import FailureSchedule
from repro_torch.netsim.topology import Topology

# "permanent" end tick: far beyond any horizon, still int32-safe for the
# engine's `now < end` arithmetic.
FOREVER = 2**30


def truncate_dead(fs: FailureSchedule, horizon: int) -> FailureSchedule:
    """Drop rows that can never be active in ``[0, horizon)`` — inert pads
    (empty windows) and events starting at/after the horizon.  Live rows
    are kept bit-unchanged, so the active-set of every tick < horizon is
    preserved exactly; a row that is live before the horizon is *never*
    dropped or clipped, even if its window extends past it."""
    s = np.asarray(fs.start)
    e = np.asarray(fs.end)
    live = (e > s) & (s < horizon)
    return FailureSchedule(
        queue=np.asarray(fs.queue, np.int32)[live],
        start=s.astype(np.int32)[live],
        end=e.astype(np.int32)[live],
        kind=np.asarray(fs.kind, np.int32)[live],
        param=np.asarray(fs.param, np.int32)[live],
    )


def link_down(queues, start: int, end: int) -> FailureSchedule:
    q = np.atleast_1d(np.asarray(queues, np.int32))
    n = len(q)
    return FailureSchedule(
        queue=q,
        start=np.full((n,), start, np.int32),
        end=np.full((n,), end, np.int32),
        kind=np.zeros((n,), np.int32),
    )


def link_degraded(queues, start: int, end: int) -> FailureSchedule:
    q = np.atleast_1d(np.asarray(queues, np.int32))
    n = len(q)
    return FailureSchedule(
        queue=q,
        start=np.full((n,), start, np.int32),
        end=np.full((n,), end, np.int32),
        kind=np.ones((n,), np.int32),
    )


def gray_loss(queues, start: int, end: int, rate: float) -> FailureSchedule:
    """Gray failure: the link stays up (and invisible to adaptive switch
    routing) but silently drops each served packet with probability
    ``rate``.  The rate is stored fixed-point (``param = round(rate *
    GRAY_SCALE)``) and the per-packet draw goes through the engine's
    threefry tick key, so runs are bit-reproducible across kill/resume."""
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"gray_loss rate must be in (0, 1], got {rate}")
    q = np.atleast_1d(np.asarray(queues, np.int32))
    n = len(q)
    param = int(round(rate * engine.GRAY_SCALE))
    return FailureSchedule(
        queue=q,
        start=np.full((n,), start, np.int32),
        end=np.full((n,), end, np.int32),
        kind=np.full((n,), engine.K_GRAY, np.int32),
        param=np.full((n,), param, np.int32),
    )


def link_flapping(
    queues, start: int, end: int, period: int, down_ticks: int
) -> FailureSchedule:
    """Flapping link(s): periodic *down* windows of ``down_ticks`` every
    ``period`` ticks, first window at ``start``, windows starting at or
    after ``end`` omitted.  Materialized as explicit kind-0 rows (one per
    down window per queue) — no new runtime kind, so the engine's
    active-set arithmetic and the pad/truncate no-resurrect semantics are
    untouched, and a flapping schedule is bit-identical to the equivalent
    hand-composed ``link_down`` stack."""
    if period <= 0 or down_ticks <= 0 or down_ticks >= period:
        raise ValueError(
            "link_flapping needs 0 < down_ticks < period, got "
            f"period={period} down_ticks={down_ticks}"
        )
    starts = np.arange(start, end, period, dtype=np.int64)
    if len(starts) == 0:
        return FailureSchedule.none()
    return FailureSchedule.concat(
        *[link_down(queues, int(s), int(s) + down_ticks) for s in starts]
    )


def switch_down(
    cfg: SimConfig, tor: int, start: int, end: int = FOREVER
) -> FailureSchedule:
    """Correlated switch-level outage: every uplink of ToR ``tor`` goes
    down at once (spine-level outages are ``spine_down``)."""
    assert 0 <= tor < cfg.n_tors, (tor, cfg.n_tors)
    topo = Topology.build(cfg)
    return link_down(topo.t0_up_queues(tor), start, end)


def switch_degraded(
    cfg: SimConfig, tor: int, start: int, end: int = FOREVER
) -> FailureSchedule:
    """Fail-slow switch: every uplink of ToR ``tor`` degrades to half
    rate at once."""
    assert 0 <= tor < cfg.n_tors, (tor, cfg.n_tors)
    topo = Topology.build(cfg)
    return link_degraded(topo.t0_up_queues(tor), start, end)


def spine_degraded(
    cfg: SimConfig, spine: int, start: int, end: int = FOREVER
) -> FailureSchedule:
    """Fail-slow spine: the uplink of every ToR that targets ``spine``
    degrades to half rate for ``[start, end)`` (the degraded sibling of
    ``spine_down``)."""
    assert cfg.tiers == 2, "spine_degraded targets the 2-tier fabric"
    assert 0 <= spine < cfg.uplinks_per_tor, (spine, cfg.uplinks_per_tor)
    topo = Topology.build(cfg)
    qs = [int(topo.t0_up_queues(t)[spine]) for t in range(cfg.n_tors)]
    return link_degraded(qs, start, end)


def random_degraded_uplinks(
    cfg: SimConfig, fraction: float, start: int = 0, end: int = FOREVER, seed: int = 0
) -> FailureSchedule:
    """Degrade a random `fraction` of TOR uplinks to half rate (fig 4)."""
    topo = Topology.build(cfg)
    rng = np.random.RandomState(seed)
    ups = np.concatenate([topo.t0_up_queues(t) for t in range(cfg.n_tors)])
    k = max(1, int(round(fraction * len(ups))))
    chosen = rng.choice(ups, k, replace=False)
    return link_degraded(chosen, start, end)


def random_down_uplinks(
    cfg: SimConfig, fraction: float, start: int, end: int, seed: int = 0
) -> FailureSchedule:
    """Take a random `fraction` of TOR uplinks fully down (fig 7/8)."""
    topo = Topology.build(cfg)
    rng = np.random.RandomState(seed)
    ups = np.concatenate([topo.t0_up_queues(t) for t in range(cfg.n_tors)])
    k = max(1, int(round(fraction * len(ups))))
    chosen = rng.choice(ups, k, replace=False)
    return link_down(chosen, start, end)


def spine_down(
    cfg: SimConfig, spine: int, start: int, end: int = FOREVER
) -> FailureSchedule:
    """Take one whole spine out of a 2-tier fabric: the uplink of *every*
    TOR that targets ``spine`` goes down for ``[start, end)``; merge it into
    a schedule with ``FailureSchedule.merge``.
    """
    assert cfg.tiers == 2, "spine_down targets the 2-tier fabric"
    assert 0 <= spine < cfg.uplinks_per_tor, (spine, cfg.uplinks_per_tor)
    topo = Topology.build(cfg)
    qs = [int(topo.t0_up_queues(t)[spine]) for t in range(cfg.n_tors)]
    return link_down(qs, start, end)


def incremental_uplink_failures(
    cfg: SimConfig, tor: int, n_fail: int, first_start: int, interval: int
) -> FailureSchedule:
    """Fail n_fail uplinks of one TOR, staggered (Appendix D.3 / fig 19)."""
    topo = Topology.build(cfg)
    ups = topo.t0_up_queues(tor)[:n_fail]
    scheds = [
        link_down([q], first_start + i * interval, FOREVER)
        for i, q in enumerate(ups)
    ]
    return FailureSchedule.concat(*scheds)
