"""Chaos engine: randomized gray-failure campaigns with machine-checked
invariants and automatic scenario shrinking (counterpart of
``repro.netsim.chaos``).

The paper's headline claim is failure *mitigation*: REPS re-routes around a
failure within a handful of RTTs.  This module turns that claim into a
continuously fuzzed property, in three layers:

1. **Fault archetypes** (``failures.py`` builders and the engine's kind
   codes): ``link_down`` / ``link_degraded`` / ``link_flapping`` /
   ``gray_loss`` / ``switch_down`` / ``switch_degraded`` / ``spine_down``,
   declared statically or injected mid-run through ``SoakRunner.inject``.
2. **Invariant checker** (``ChaosInvariants``): per-chunk checks on the
   carries the soak runtime already holds, and post-hoc checks on its
   telemetry: packet-slot conservation, delivered-bitmap consistency,
   monotone counters, bounded-window delivery progress (no livelock),
   completion, the recovery-latency bound, and kill/resume bit-parity under
   active chaos.
3. **Campaign runner** (``ChaosCampaign``): seeded random scenarios over the
   archetype space, driven through ``SoakRunner`` grids with mid-run
   injection.  A violating scenario is shrunk deterministically (drop
   faults one at a time, halve conns, halve the horizon, halve messages) to
   a minimal repro, emitted as a replayable JSON artifact with a one-line
   repro command (``python -m repro_torch.bench.chaos_campaign``).

The known-bad fixture is the paper's own counter-example: ``ecmp`` under a
permanent spine outage never re-routes, so its connections on dead spines
never complete; the same scenario under ``reps`` passes.

Everything runs on the engine's device (the card unless ``device="cpu"``);
scenario draws are host numpy, ``RandomState(seed * 100003 + index)``, as
in the reference.  The port's row-batched leaves carry one sentinel slot
each (``pkt (B, PF, NP + 1)``, ``c_rcv (B, NC + 1, MSG)``); the monitor
slices it off before it counts, so that every check sees the reference's
shapes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
import types
from typing import Any, Optional

import numpy as np

from repro_torch.netsim import failures, workloads
from repro_torch.netsim.engine import FREE, PS, ST_DELIVERED, FailureSchedule
from repro_torch.netsim.soak import SoakConfig, SoakRunner
from repro_torch.netsim.sweep import SweepCase, SweepEngine
from repro_torch.netsim.topology import Topology
from repro_torch.tree import tree_map

ARCHETYPES = (
    "link_down", "link_degraded", "link_flapping", "gray_loss", "switch",
)
REPRO_CMD = "PYTHONPATH=src python -m repro_torch.bench.chaos_campaign"


# ---------------------------------------------------------------------------
# Scenario description: plain data, JSON round-trippable.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChaosFault:
    """One fault in a scenario, addressed by fabric coordinates (ToR /
    spine index) rather than queue ids, so that a shrunk scenario stays
    meaningful when built again.  ``inject_at >= 0`` makes it a live
    mid-run injection through ``SoakRunner.inject`` at that tick instead of
    a statically declared row."""

    archetype: str  # one of ARCHETYPES | "switch_down" | ... (see build)
    tor: int = 0
    spine: int = 0
    start: int = 0
    end: int = 0
    period: int = 0  # link_flapping
    down_ticks: int = 0  # link_flapping
    rate: float = 0.0  # gray_loss
    inject_at: int = -1

    def build(self, cfg) -> FailureSchedule:
        topo = Topology.build(cfg)
        q = int(topo.t0_up_queues(self.tor)[self.spine])
        if self.archetype == "link_down":
            return failures.link_down([q], self.start, self.end)
        if self.archetype == "link_degraded":
            return failures.link_degraded([q], self.start, self.end)
        if self.archetype == "link_flapping":
            return failures.link_flapping([q], self.start, self.end, self.period,
                                          self.down_ticks)
        if self.archetype == "gray_loss":
            return failures.gray_loss([q], self.start, self.end, self.rate)
        if self.archetype == "switch_down":
            return failures.switch_down(cfg, self.tor, self.start, self.end)
        if self.archetype == "switch_degraded":
            return failures.switch_degraded(cfg, self.tor, self.start, self.end)
        if self.archetype == "spine_down":
            return failures.spine_down(cfg, self.spine, self.start, self.end)
        raise ValueError(f"unknown fault archetype {self.archetype!r}")


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """One runnable chaos scenario: a seeded workload, an LB and a fault
    set.  Everything is plain data, so that a violation serializes to a
    replayable JSON artifact; ``n_conns = 0`` means the full permutation."""

    name: str
    seed: int
    lb: str
    msg_pkts: int
    ticks: int
    chunk: int
    faults: tuple[ChaosFault, ...] = ()
    n_conns: int = 0
    resume_check: bool = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = [dataclasses.asdict(f) for f in self.faults]
        return d

    @staticmethod
    def from_dict(d: dict) -> "ChaosScenario":
        d = dict(d)
        d["faults"] = tuple(ChaosFault(**f) for f in d.get("faults", ()))
        return ChaosScenario(**d)

    def static_schedule(self, cfg) -> FailureSchedule:
        parts = [f.build(cfg) for f in self.faults if f.inject_at < 0]
        return FailureSchedule.concat(*parts) if parts else FailureSchedule.none()

    def injected(self) -> list[ChaosFault]:
        return sorted((f for f in self.faults if f.inject_at >= 0), key=lambda f: f.inject_at)

    def workload(self, cfg):
        wl = workloads.permutation(cfg.n_hosts, self.msg_pkts, seed=self.seed)
        if self.n_conns and self.n_conns < wl.n_conns:
            k = self.n_conns
            wl = dataclasses.replace(
                wl, src=wl.src[:k], dst=wl.dst[:k], msg_pkts=wl.msg_pkts[:k],
                start=wl.start[:k], dep=wl.dep[:k],
            )
        return wl


# ---------------------------------------------------------------------------
# Invariants.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Violation:
    invariant: str
    cell: str
    tick: int
    detail: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ChaosInvariants:
    """Declarative invariant suite, evaluated against a running
    ``SoakRunner`` (per chunk, from the carries it holds) and its finished
    result (post hoc, from the telemetry).

    * ``conservation``: every one of the NP packet slots is on the free
      list or holds a non-FREE packet.
    * ``delivered_bitmap``: per-conn delivered counters equal the popcount
      of the received-seq bitmap.
    * ``monotone``: cumulative stats, per-conn delivery counters and
      completion flags never move backwards between chunk boundaries.
    * ``no_livelock``: a row that is not quiescent and not past its own
      horizon makes delivery progress within ``no_progress_window`` ticks
      (``ChaosCampaign`` sizes the window per scenario).
    * ``completion``: every connection completes by the horizon (asserted
      only for survivable scenarios).
    * ``recovery``: if a failure drop was observed, a delivery after it
      happened within ``recovery_bound_ticks``.
    * kill/resume bit-parity is campaign-level (it needs a second run):
      ``ChaosCampaign`` checks it on scenarios with ``resume_check``.
    """

    no_progress_window: int = 2048
    recovery_bound_ticks: int = 2048
    require_completion: bool = True
    check_recovery: bool = True

    def monitor(self, runner: SoakRunner) -> "InvariantMonitor":
        return InvariantMonitor(runner, self)


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


class InvariantMonitor:
    """Stateful evaluation of a ``ChaosInvariants`` suite over one soak
    run: call ``boundary()`` after each ``advance`` (chunk snapshot checks)
    and ``final(result)`` after ``runner.result()``."""

    def __init__(self, runner: SoakRunner, inv: ChaosInvariants):
        self.runner = runner
        self.inv = inv
        # the connection table never changes under injection: one host copy
        self._scn_host = [tree_map(_host, b.scn) for b in runner.engine.buckets]
        self._prev: list[Optional[dict]] = [None] * len(runner.engine.buckets)
        self._last_progress: list[np.ndarray] = [
            np.zeros((b.plan.n_padded_rows,), np.int64) for b in runner.engine.buckets
        ]

    # -- helpers --------------------------------------------------------
    def _states(self, bi: int):
        """The leaves the checks read, on the host, the sentinel slots
        sliced off on the device before the copy (``pkt`` keeps only its
        state row ``PS``: ``(B, NP)``; ``c_rcv`` is ``(B, NC, MSG)``)."""
        carry = self.runner.carries[bi]
        st = carry[0] if self.runner.config.collect == "summary" else carry
        return types.SimpleNamespace(
            pkt_state=_host(st.pkt[:, PS, :-1]),
            c_rcv=_host(st.c_rcv[:, :-1]),
            **{f: _host(getattr(st, f)) for f in (
                "fl_count", "c_delivered", "s_stats", "c_done", "c_rtx_count", "c_next_new")},
        )

    def _rows(self, bucket):
        for c in bucket.cells:
            for si, row in enumerate(c.rows):
                yield c.case.name, si, row

    @staticmethod
    def _quiet_rows(states, scn, horizons, NP: int) -> np.ndarray:
        """Host-side mirror of the engine's per-row quiescence predicate."""
        no_pkts = np.asarray(states.fl_count) == NP
        conn_dep = np.asarray(scn.conn_dep)
        dep = np.clip(conn_dep, 0, conn_dep.shape[-1] - 1)
        dep_ok = (conn_dep < 0) | np.take_along_axis(np.asarray(states.c_done), dep, axis=-1)
        startable = (np.asarray(scn.conn_start) < horizons[:, None]) & dep_ok
        has_work = (np.asarray(states.c_rtx_count) > 0) | (
            np.asarray(states.c_next_new) < np.asarray(scn.conn_msg)
        )
        active = startable & ~np.asarray(states.c_done) & has_work
        return no_pkts & ~active.any(axis=-1)

    # -- per-chunk checks -----------------------------------------------
    def boundary(self) -> list[Violation]:
        out: list[Violation] = []
        cursor = self.runner.cursor
        for bi, bucket in enumerate(self.runner.engine.buckets):
            NP = bucket.program.sim.NP
            st = self._states(bi)
            scn = self._scn_host[bi]
            horizons = np.asarray(bucket.horizons, np.int64)
            alloc = (st.pkt_state != FREE).sum(axis=-1)
            fl_count = np.asarray(st.fl_count, np.int64)
            delivered_map = st.c_rcv.sum(axis=-1)
            c_delivered = np.asarray(st.c_delivered, np.int64)
            s_stats = np.asarray(st.s_stats, np.int64)
            c_done = st.c_done
            quiet = self._quiet_rows(st, scn, horizons, NP)
            prev = self._prev[bi]
            for name, si, row in self._rows(bucket):
                cell = f"{name}[seed {si}]"
                if fl_count[row] + alloc[row] != NP:
                    out.append(Violation(
                        "conservation", cell, cursor,
                        f"free {int(fl_count[row])} + allocated "
                        f"{int(alloc[row])} != {NP} packet slots",
                    ))
                bad = np.nonzero(c_delivered[row] != delivered_map[row])[0]
                if len(bad):
                    out.append(Violation(
                        "delivered_bitmap", cell, cursor,
                        f"conn {int(bad[0])}: c_delivered "
                        f"{int(c_delivered[row][bad[0]])} != bitmap popcount "
                        f"{int(delivered_map[row][bad[0]])}",
                    ))
                if prev is not None:
                    if (s_stats[row] < prev["s_stats"][row]).any():
                        out.append(Violation(
                            "monotone", cell, cursor,
                            f"cumulative stats decreased: "
                            f"{prev['s_stats'][row].tolist()} -> "
                            f"{s_stats[row].tolist()}",
                        ))
                    if (c_delivered[row] < prev["c_delivered"][row]).any():
                        out.append(Violation(
                            "monotone", cell, cursor, "per-conn delivered counter decreased",
                        ))
                    if (prev["c_done"][row] & ~c_done[row]).any():
                        out.append(Violation(
                            "monotone", cell, cursor, "completed connection un-completed",
                        ))
                # delivery progress (no livelock)
                d = int(s_stats[row][ST_DELIVERED])
                d0 = int(prev["s_stats"][row][ST_DELIVERED]) if prev is not None else -1
                if d != d0:
                    self._last_progress[bi][row] = cursor
                stalled = cursor - int(self._last_progress[bi][row])
                if (not quiet[row] and cursor < int(horizons[row])
                        and stalled > self.inv.no_progress_window):
                    out.append(Violation(
                        "no_livelock", cell, cursor,
                        f"no delivery progress for {stalled} ticks "
                        f"(window {self.inv.no_progress_window}) with "
                        "unfinished work pending",
                    ))
            self._prev[bi] = {"s_stats": s_stats, "c_delivered": c_delivered, "c_done": c_done}
        return out

    # -- post-hoc checks ------------------------------------------------
    def final(self, result) -> list[Violation]:
        out: list[Violation] = []
        summaries = result.summaries()
        for name, per_seed in summaries.items():
            for si, s in enumerate(per_seed):
                cell = f"{name}[seed {si}]"
                if self.inv.require_completion and s.completed < s.n_conns:
                    out.append(Violation(
                        "completion", cell, -1,
                        f"{s.completed}/{s.n_conns} connections completed by the horizon",
                    ))
                if not self.inv.check_recovery:
                    continue
                rec = result.telemetry_for(name, si).get("recovery")
                if rec is None:
                    continue
                drop = rec["first_drop_tick"]
                rticks = rec["recovery_ticks"]
                if drop >= 0 and rticks < 0:
                    out.append(Violation(
                        "recovery", cell, drop,
                        f"failure drop at tick {drop} but no delivery afterwards (no re-route)",
                    ))
                elif drop >= 0 and rticks > self.inv.recovery_bound_ticks:
                    out.append(Violation(
                        "recovery", cell, drop,
                        f"recovery took {rticks} ticks (bound {self.inv.recovery_bound_ticks})",
                    ))
        return out


# ---------------------------------------------------------------------------
# Campaign runner with shrinking.
# ---------------------------------------------------------------------------


def scenario_record(result) -> dict:
    """Canonical record of a finished run: every RunSummary field plus a
    sha256 of every telemetry sketch row, the bit-parity unit of kill/resume
    checks and artifact replays."""
    record: dict[str, Any] = {"summaries": {}, "telemetry_sha": {}}
    summaries = result.summaries()
    for name in sorted(summaries):
        record["summaries"][name] = [dataclasses.asdict(s) for s in summaries[name]]
    for b in result.buckets:
        if b.telemetry is None:
            continue
        for c in b.cells:
            record["telemetry_sha"][c.case.name] = [
                hashlib.sha256(np.ascontiguousarray(b.telemetry[row]).tobytes()).hexdigest()
                for row in c.rows
            ]
    return record


def record_digest(record: dict) -> str:
    return hashlib.sha256(json.dumps(record, sort_keys=True).encode()).hexdigest()


class ChaosCampaign:
    """Seeded random chaos campaign: generate scenarios over the fault
    archetype space, drive each through a checkpointable ``SoakRunner`` grid
    with mid-run injection, check ``ChaosInvariants`` at every chunk
    boundary and post hoc, and shrink any violating scenario to a minimal
    replayable repro.

    ``budget_s`` bounds wall clock (checked between scenarios);
    ``min_scenarios`` run regardless, which with the default generator
    covers every archetype.  All randomness flows from
    ``np.random.RandomState(seed * 100003 + index)``: the same seed always
    gives the same campaign.  ``device`` is the engines' (the card unless
    ``"cpu"``).
    """

    # sizing knobs for generated scenarios (CI scale): messages still in
    # flight when the fault windows open
    TICKS = 1280
    CHUNK = 160
    MSG_PKTS = 64

    def __init__(
        self,
        seed: int,
        budget_s: float = 180.0,
        min_scenarios: int = len(ARCHETYPES),
        max_scenarios: int | None = None,
        cfg=None,
        lb: str = "reps",
        min_failure_slots: int = 32,
        invariants: ChaosInvariants | None = None,
        device=None,
    ):
        if cfg is None:
            from repro_torch.configs.arcane_paper import FATTREE_32_CI

            cfg = FATTREE_32_CI
        self.seed = int(seed)
        self.budget_s = float(budget_s)
        self.min_scenarios = int(min_scenarios)
        self.max_scenarios = max_scenarios
        self.cfg = cfg
        self.lb = lb
        self.min_failure_slots = int(min_failure_slots)
        self.invariants = invariants
        self.device = device

    # -- scenario generation --------------------------------------------
    def _slack(self) -> int:
        """Ticks a service-stopping window must leave before the horizon so
        that every blackholed packet is retransmitted and delivered."""
        return self.cfg.rto_ticks + 2 * self.CHUNK + 128

    def generate(self, index: int) -> ChaosScenario:
        """Deterministic scenario ``index``: the primary fault cycles the
        archetype list, a second fault on another ToR and spine rides along
        half the time, and some primaries arrive as live mid-run injections
        instead of static schedule rows."""
        rng = np.random.RandomState(self.seed * 100003 + index)
        cfg = self.cfg
        ticks, chunk = self.TICKS, self.CHUNK
        down_end_max = ticks - self._slack()

        tors = rng.permutation(cfg.n_tors)
        spines = rng.permutation(cfg.uplinks_per_tor)

        def make_fault(archetype, tor, spine):
            # windows open while traffic is in flight; service-stopping ones
            # close `slack` before the horizon
            if archetype == "link_down":
                start = int(rng.randint(8, 160))
                end = int(rng.randint(start + 64, down_end_max))
                return ChaosFault("link_down", tor, spine, start, end)
            if archetype == "link_degraded":
                start = int(rng.randint(0, 160))
                end = failures.FOREVER if rng.rand() < 0.5 else int(
                    rng.randint(start + 64, ticks))
                return ChaosFault("link_degraded", tor, spine, start, end)
            if archetype == "link_flapping":
                down = int(rng.randint(48, 128))
                period = down + cfg.rto_ticks + int(rng.randint(64, 192))
                start = int(rng.randint(8, 96))
                end = max(start + 1, down_end_max - down)
                return ChaosFault("link_flapping", tor, spine, start, end,
                                  period=period, down_ticks=down)
            if archetype == "gray_loss":
                start = int(rng.randint(0, 160))
                end = int(rng.randint(start + 128, down_end_max))
                rate = float(rng.uniform(0.05, 0.4))
                return ChaosFault("gray_loss", tor, spine, start, end, rate=round(rate, 4))
            if archetype != "switch":
                raise ValueError(f"unknown fault archetype {archetype!r}")
            start = int(rng.randint(8, 160))
            if rng.rand() < 0.34:
                end = int(rng.randint(start + 64, down_end_max))
                return ChaosFault("switch_down", tor, spine, start, end)
            if rng.rand() < 0.5:
                end = int(rng.randint(start + 64, down_end_max))
                return ChaosFault("spine_down", tor, spine, start, end)
            return ChaosFault("switch_degraded", tor, spine, start,
                              int(rng.randint(start + 64, ticks)))

        primary = make_fault(ARCHETYPES[index % len(ARCHETYPES)], int(tors[0]), int(spines[0]))
        flist = [primary]
        if rng.rand() < 0.5:
            extra_kind = ARCHETYPES[int(rng.randint(len(ARCHETYPES)))]
            # distinct ToR and distinct spine: disjoint queues under every
            # combination, so the merge's overlap rejection never fires
            flist.append(make_fault(extra_kind, int(tors[1]), int(spines[1])))
        if rng.rand() < 0.4:
            # live injection, pushed past the first chunk boundary so that
            # it lands before its window opens
            shifted = max(primary.start, chunk + 8)
            horizon_end = min(primary.end, ticks)
            if shifted + 64 <= horizon_end:
                flist[0] = dataclasses.replace(primary, start=shifted, inject_at=chunk)
        return ChaosScenario(
            name=f"chaos/{self.lb}/s{self.seed}i{index}",
            seed=self.seed * 7919 + index,
            lb=self.lb,
            msg_pkts=self.MSG_PKTS,
            ticks=ticks,
            chunk=chunk,
            faults=tuple(flist),
            resume_check=(index == 0),
        )

    # -- scenario execution ---------------------------------------------
    def _invariants_for(self, scenario: ChaosScenario) -> ChaosInvariants:
        if self.invariants is not None:
            return self.invariants
        # longest legitimate delivery stall: the longest service-stopping
        # window, plus one RTO for the retransmit, plus chunk rounding
        longest_down = 0
        for f in scenario.faults:
            if f.archetype in ("link_down", "switch_down", "spine_down"):
                end = min(f.end, scenario.ticks)
                longest_down = max(longest_down, end - f.start)
            elif f.archetype == "link_flapping":
                longest_down = max(longest_down, f.down_ticks)
        window = longest_down + self.cfg.rto_ticks + 2 * scenario.chunk + 64
        return ChaosInvariants(
            no_progress_window=window,
            recovery_bound_ticks=self.cfg.rto_ticks + scenario.ticks // 2,
        )

    def _runner(self, scenario: ChaosScenario, ckpt_dir: str | None = None) -> SoakRunner:
        case = SweepCase(
            name=scenario.name,
            workload=scenario.workload(self.cfg),
            lb=scenario.lb,
            ticks=scenario.ticks,
            failures=scenario.static_schedule(self.cfg),
            seeds=(scenario.seed,),
        )
        engine = SweepEngine(self.cfg, [case], min_failure_slots=self.min_failure_slots,
                             device=self.device)
        return SoakRunner(engine, SoakConfig(chunk=scenario.chunk, ckpt_dir=ckpt_dir,
                                             collect="summary"))

    def _drive(self, runner: SoakRunner, scenario: ChaosScenario,
               monitor: InvariantMonitor | None, stop_at: int | None = None) -> list[Violation]:
        """Advance to the horizon (or ``stop_at``) chunk by chunk, injecting
        scheduled faults and checking invariants at every boundary."""
        violations: list[Violation] = []
        # a resumed runner replays logged injections from the snapshot, so
        # only faults strictly past its cursor are still ours to apply
        pending = [f for f in scenario.injected() if f.inject_at > runner.cursor]
        target = scenario.ticks if stop_at is None else stop_at
        while runner.cursor < target:
            nxt = min(runner.cursor + scenario.chunk, target,
                      *[f.inject_at for f in pending if f.inject_at > runner.cursor])
            runner.advance(nxt - runner.cursor)
            while pending and pending[0].inject_at <= runner.cursor:
                runner.inject(pending.pop(0).build(self.cfg))
            if monitor is not None:
                violations.extend(monitor.boundary())
        return violations

    def run_scenario(self, scenario: ChaosScenario) -> tuple[list[Violation], dict]:
        """One scenario end to end.  Returns ``(violations, record)``; the
        record's digest is the scenario's bit-parity identity."""
        inv = self._invariants_for(scenario)
        runner = self._runner(scenario)
        monitor = inv.monitor(runner)
        violations = self._drive(runner, scenario, monitor)
        result = runner.result()
        violations.extend(monitor.final(result))
        record = scenario_record(result)
        if scenario.resume_check:
            violations.extend(self._check_resume_parity(scenario, record))
        return violations, record

    def _check_resume_parity(self, scenario: ChaosScenario,
                             straight_record: dict) -> list[Violation]:
        """Kill/resume bit-parity under active chaos: checkpoint, abandon the
        runner mid-run, resume from disk in a fresh engine, finish, and
        require a byte-identical record."""
        kill_at = (scenario.ticks // 2 // scenario.chunk) * scenario.chunk
        with tempfile.TemporaryDirectory(prefix="chaos_ck_") as ck:
            first = self._runner(scenario, ckpt_dir=ck)
            self._drive(first, scenario, None, stop_at=kill_at)
            del first  # the hard kill: no finalize, no further saves
            resumed = self._runner(scenario, ckpt_dir=ck)
            resumed.resume()
            self._drive(resumed, scenario, None)
            record = scenario_record(resumed.result())
        if record_digest(record) != record_digest(straight_record):
            return [Violation(
                "resume_parity", scenario.name, kill_at,
                "kill/resume record differs from the uninterrupted run "
                f"({record_digest(record)[:12]} != {record_digest(straight_record)[:12]})",
            )]
        return []

    # -- shrinking -------------------------------------------------------
    def _reductions(self, s: ChaosScenario) -> list[ChaosScenario]:
        """Candidate simplifications, most aggressive first; each keeps the
        scenario well formed (faults fitting the shrunk horizon)."""
        out: list[ChaosScenario] = []
        base = dataclasses.replace(s, resume_check=False)
        for i in range(len(s.faults)):
            kept = tuple(f for j, f in enumerate(s.faults) if j != i)
            if kept:
                out.append(dataclasses.replace(base, faults=kept))
        nc = s.n_conns or self.cfg.n_hosts
        if nc > 4:
            out.append(dataclasses.replace(base, n_conns=nc // 2))
        if s.ticks // 2 >= 2 * s.chunk:
            half = (s.ticks // 2 // s.chunk) * s.chunk
            kept = tuple(f for f in s.faults
                         if f.start < half and (f.inject_at < 0 or f.inject_at < half))
            if kept:
                out.append(dataclasses.replace(base, ticks=half, faults=kept))
        if s.msg_pkts > 4:
            out.append(dataclasses.replace(base, msg_pkts=s.msg_pkts // 2))
        return out

    def shrink(self, scenario: ChaosScenario) -> tuple[ChaosScenario, list[Violation], dict]:
        """Greedy deterministic shrink to a local minimum: try each reduction
        in order, keep the first that still violates, repeat to a fixpoint.
        Returns ``(minimal scenario, its violations, record)``."""
        current = dataclasses.replace(scenario, resume_check=False)
        violations, record = self.run_scenario(current)
        if not violations:
            raise ValueError("shrink() needs a violating scenario")
        progress = True
        while progress:
            progress = False
            for cand in self._reductions(current):
                v, rec = self.run_scenario(cand)
                if v:
                    current, violations, record = cand, v, rec
                    progress = True
                    break
        return current, violations, record

    def make_artifact(self, scenario: ChaosScenario, violations: list[Violation],
                      record: dict) -> dict:
        return {
            "schema": 1,
            "campaign_seed": self.seed,
            "lb": self.lb,
            "scenario": scenario.to_dict(),
            "violations": [v.to_dict() for v in violations],
            "record_digest": record_digest(record),
            "repro": f"{REPRO_CMD} --replay <this file>",
        }

    def replay(self, artifact: dict) -> tuple[list[Violation], bool]:
        """Re-run an artifact's scenario.  Returns ``(violations,
        bit_exact)``, ``bit_exact`` being digest equality with the recorded
        run: the artifact's reproducibility contract."""
        scenario = ChaosScenario.from_dict(artifact["scenario"])
        violations, record = self.run_scenario(scenario)
        return violations, record_digest(record) == artifact["record_digest"]

    # -- the campaign loop ----------------------------------------------
    def run(self, artifact_dir: str | None = None, log=print) -> dict:
        """Run scenarios until the budget (but at least ``min_scenarios``).
        On the first violation: shrink, write the artifact (when
        ``artifact_dir`` is given) and stop.  Returns a report dict
        (``violations`` empty on a clean campaign)."""
        t0 = time.time()
        report: dict[str, Any] = {
            "seed": self.seed, "lb": self.lb, "scenarios": [],
            "violations": [], "artifact": None,
        }
        index = 0
        while True:
            over_budget = time.time() - t0 > self.budget_s
            if index >= self.min_scenarios and over_budget:
                break
            if self.max_scenarios is not None and index >= self.max_scenarios:
                break
            scenario = self.generate(index)
            log(f"[chaos] scenario {index}: "
                + ", ".join(f.archetype for f in scenario.faults)
                + (" (+resume check)" if scenario.resume_check else ""))
            violations, record = self.run_scenario(scenario)
            report["scenarios"].append({
                "name": scenario.name,
                "faults": [f.archetype for f in scenario.faults],
                "violations": len(violations),
            })
            if violations:
                log(f"[chaos] VIOLATION in {scenario.name}: "
                    f"{violations[0].invariant} — shrinking")
                minimal, mv, mrec = self.shrink(scenario)
                artifact = self.make_artifact(minimal, mv, mrec)
                report["violations"] = [v.to_dict() for v in mv]
                report["artifact"] = artifact
                if artifact_dir:
                    os.makedirs(artifact_dir, exist_ok=True)
                    path = os.path.join(artifact_dir, f"chaos_repro_s{self.seed}i{index}.json")
                    with open(path, "w") as fh:
                        json.dump(artifact, fh, indent=2, sort_keys=True)
                    report["artifact_path"] = path
                    log(f"[chaos] minimal repro written to {path}")
                break
            index += 1
        report["elapsed_s"] = round(time.time() - t0, 2)
        report["n_scenarios"] = index + (1 if report["violations"] else 0)
        return report


def known_bad_scenario(cfg=None, ticks: int = 1280, chunk: int = 160) -> ChaosScenario:
    """The seeded known-bad fixture: ``ecmp`` under a permanent outage of
    half the spines.  Static per-conn paths never re-route, so connections
    hashed onto dead spines never finish and the completion invariant fires
    deterministically; the same faults under ``reps`` pass."""
    return ChaosScenario(
        name="chaos/known_bad/ecmp_half_fabric",
        seed=7,
        lb="ecmp",
        msg_pkts=24,
        ticks=ticks,
        chunk=chunk,
        faults=tuple(
            ChaosFault("spine_down", tor=0, spine=sp, start=8, end=failures.FOREVER)
            for sp in range(4)
        ),
    )
