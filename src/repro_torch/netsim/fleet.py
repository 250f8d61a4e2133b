"""Fleet execution: one scenario under many seeds in lock-step (counterpart
of ``repro.netsim.fleet``).

A sweep in the paper's evaluation style runs the same scenario structure
(topology, workload, load balancer, failure schedule) under many seeds.
Run one after another, each run pays the tick's fixed cost, which on the
card is the host issuing a few hundred small launches per tick.
``FleetRunner`` steps every seed's run in one tick over state with a
leading row axis B (``Simulator.step_rows``): each kernel is one launch per
tick whatever B is, so the fixed cost is paid once for the whole fleet.
Nothing loops over rows inside the tick, and there is one tick body: a
one-run ``Simulator`` is its B = 1 case.

Each row of a fleet run is bit-identical to the serial ``Simulator(seed=s)``
run and to the JAX ``FleetRunner``'s row (tests/test_torch_fleet.py).

``run_summary`` is the summary path: the spec's telemetry channels are
folded into the tick on the device (``repro_torch.netsim.telemetry``) and
leave it once, as one ``(B, size)`` int32 carry.  ``run``, ``run_summary``
and ``summaries`` take an optional ``scn``: a ``ScenarioArrays`` with one
row per seed (``engine.stack_scenarios``), so that the rows differ in
workload, failure schedule and watch list at the simulator's shapes.

Example (on the card; pass ``device="cpu"`` for the plain versions):

    fleet = FleetRunner(cfg, wl, make_lb("reps"), seeds=range(8))
    states, traces = fleet.run(4000)        # leading axis = seed
    for s in fleet.summaries(states): ...   # per-seed RunSummary
    states, tel = fleet.run_summary(4000)   # TelemetrySpec.default()
    tel.summaries()[0].p99_fct_ticks        # sketch p99, seed 0
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import rng
from repro_torch.core.load_balancers import LoadBalancer
from repro_torch.netsim.config import SimConfig
from repro_torch.netsim.engine import (
    FailureSchedule, ScenarioArrays, Simulator, SimState, Workload, tree_map,
)
from repro_torch.netsim.metrics import RunSummary, summarize, summarize_sketch
from repro_torch.netsim.telemetry import TelemetryProgram, TelemetrySpec


class FleetRunner:
    """Runs one scenario structure under a batch of seeds in lock-step.

    The port has one kernel path per device (the hand-written kernels on a
    CUDA device, their plain versions on the CPU), so ``kernels_backend``
    takes only ``None``; ``device`` picks the path.
    """

    def __init__(
        self,
        cfg: SimConfig,
        workload: Workload,
        lb: LoadBalancer,
        failures: FailureSchedule | None = None,
        watch_queues=None,
        seeds: Sequence[int] = (0,),
        kernels_backend: str | None = None,
        device=None,
    ):
        self.seeds = tuple(int(s) for s in seeds)
        if not self.seeds:
            raise ValueError("need at least one seed")
        if kernels_backend is not None:
            raise ValueError(
                f"kernels_backend={kernels_backend!r}: the port has one kernel path per "
                "device, and the device picks it (pass device=...)"
            )
        self.sim = Simulator(
            cfg, workload, lb, failures=failures, watch_queues=watch_queues,
            seed=self.seeds[0], device=device,
        )
        self._tel_progs: dict = {}  # (spec, horizon) -> TelemetryProgram

    @property
    def n_runs(self) -> int:
        return len(self.seeds)

    # ------------------------------------------------------------------
    def base_keys(self) -> torch.Tensor:
        """``(B, 2)``: each seed's ``PRNGKey``."""
        return torch.stack([rng.PRNGKey(s, device=self.sim.device) for s in self.seeds])

    def init_states(self) -> SimState:
        """Per-seed initial states (each load balancer's from its seed's
        ``fold_in(key, 777)``), stacked on a leading fleet axis; made once
        per fleet, row by row."""
        rows = [self.sim.init_state(k) for k in self.base_keys()]
        return tree_map(lambda *leaves: torch.stack(leaves), *rows)

    def run(self, n_ticks: int, states: SimState | None = None,
            scn: ScenarioArrays | None = None):
        """Advance the whole fleet ``n_ticks``; returns ``(states, traces)``
        with a leading fleet axis (traces ``(n_ticks, n_runs, ...)``).  As in
        the reference, the ticks are numbered from 0 even when ``states`` is
        passed in.  ``scn``: one scenario per row (default: the fleet's)."""
        if states is None:
            states = self.init_states()
        return self.sim.run_rows(n_ticks, states, self.base_keys(), scn)

    def program(self, spec: TelemetrySpec, horizon: int) -> TelemetryProgram:
        """``spec`` laid out against this fleet's simulator for ``horizon``
        ticks, made once per ``(spec, horizon)``."""
        key = (spec, int(horizon))
        if key not in self._tel_progs:
            self._tel_progs[key] = spec.build(self.sim, int(horizon))
        return self._tel_progs[key]

    def run_summary(
        self,
        n_ticks: int,
        spec: TelemetrySpec | None = None,
        states: SimState | None = None,
        tel=None,
        t0: int = 0,
        horizon: int | None = None,
        scn: ScenarioArrays | None = None,
    ) -> tuple[SimState, "FleetTelemetry"]:
        """Advance the fleet ``n_ticks`` with the spec's telemetry channels
        folded into every tick on the device (``TelemetrySpec.default()``
        when ``spec`` is None); returns the stacked final states and a
        ``FleetTelemetry``.  No per-tick trace is made, and the carry leaves
        the device once, at the end.

        Chunked resume, as the reference's: pass the previous call's
        ``states`` and ``telemetry.tel`` back with ``t0`` (the ticks already
        run) and the total ``horizon``; the ticks are numbered from ``t0``,
        so the chunks together equal one call.  ``horizon`` defaults to ``t0
        + n_ticks``.  ``scn``: one scenario per row (default: the fleet's).
        The given ``states`` and ``tel`` are left unchanged."""
        spec = spec or TelemetrySpec.default()
        horizon = int(horizon if horizon is not None else t0 + n_ticks)
        prog = self.program(spec, horizon)
        sim = self.sim
        if states is None:
            states = self.init_states()
        if tel is None:
            tel = prog.init_rows(self.n_runs)
        else:  # the carry is updated in place: on a copy of the caller's
            tel = torch.as_tensor(tel, device=sim.device).to(torch.int32, copy=True)
        if tel.shape != (self.n_runs, prog.size):
            raise ValueError(f"tel must be ({self.n_runs}, {prog.size}), got {tuple(tel.shape)}")
        keys = self.base_keys()
        chunk = sim.draw_chunk(self.n_runs)
        for c0 in range(int(t0), int(t0) + int(n_ticks), chunk):
            n = min(chunk, int(t0) + int(n_ticks) - c0)
            draws = sim.tick_draws(keys, c0, n, scn)
            for i in range(n):
                states, probe = sim.step_probe_rows(states, c0 + i, draws.row(i), scn)
                prog.update(tel, probe)
        return states, FleetTelemetry(self, prog, tel.cpu().numpy(),
                                      min(horizon, int(t0) + int(n_ticks)))

    # ------------------------------------------------------------------
    def state_at(self, states: SimState, i: int) -> SimState:
        """Run ``i``'s SimState out of the stacked fleet state (views)."""
        return tree_map(lambda x: x[i], states)

    def summaries(self, states: SimState, name: str | None = None,
                  scn: ScenarioArrays | None = None) -> list[RunSummary]:
        """One ``RunSummary`` per seed: one device-to-host copy per leaf for
        the whole fleet, then ``metrics.summarize`` row by row on the host
        (each row's FCTs from its own start ticks when ``scn`` is given)."""
        host = tree_map(lambda x: x.cpu(), states)
        start = (self.sim.conn_start if scn is None else scn.conn_start).cpu().numpy()
        return [summarize(self.sim, self.state_at(host, i), name=name,
                          conn_start=start if scn is None else start[i])
                for i in range(self.n_runs)]


class FleetTelemetry:
    """Host-side view of a fleet's stacked telemetry carry (one
    device-to-host copy for the whole fleet): one finalized channel dict per
    seed, and sketch-built ``RunSummary`` rows (counters, completions,
    runtime and mean FCT equal to the state path's)."""

    def __init__(self, fleet: FleetRunner, prog: TelemetryProgram, tel, n_ticks: int):
        self.fleet = fleet
        self.prog = prog
        self.tel = tel  # (n_runs, size) int32 numpy
        self.n_ticks = n_ticks

    @property
    def nbytes_per_run(self) -> int:
        return self.prog.nbytes

    def result(self, i: int = 0) -> dict:
        return self.prog.finalize_row(self.tel[i], self.n_ticks)

    def summaries(self, name: str | None = None) -> list[RunSummary]:
        sim = self.fleet.sim
        return [summarize_sketch(self.result(i), name=name or sim.wl.name, lb_name=sim.lb.name,
                                 n_conns=sim.wl.n_conns)
                for i in range(self.fleet.n_runs)]
