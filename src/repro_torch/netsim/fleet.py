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

Example (on the card; pass ``device="cpu"`` for the plain versions):

    fleet = FleetRunner(cfg, wl, make_lb("reps"), seeds=range(8))
    states, traces = fleet.run(4000)        # leading axis = seed
    for s in fleet.summaries(states): ...   # per-seed RunSummary

The telemetry path (``run_summary``, ``FleetTelemetry``) waits for the port
of ``netsim/telemetry.py`` (ROADMAP.md, queue 1 item 9).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import rng
from repro_torch.core.load_balancers import LoadBalancer
from repro_torch.netsim.config import SimConfig
from repro_torch.netsim.engine import FailureSchedule, Simulator, SimState, Workload, tree_map
from repro_torch.netsim.metrics import RunSummary, summarize

_TELEMETRY = ("the fleet's telemetry path needs the port of netsim/telemetry.py, which is "
              "not done yet; see ROADMAP.md, queue 1 item 9")


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

    def run(self, n_ticks: int, states: SimState | None = None):
        """Advance the whole fleet ``n_ticks``; returns ``(states, traces)``
        with a leading fleet axis (traces ``(n_ticks, n_runs, ...)``).  As in
        the reference, the ticks are numbered from 0 even when ``states`` is
        passed in."""
        if states is None:
            states = self.init_states()
        return self.sim.run_rows(n_ticks, states, self.base_keys())

    def run_summary(self, *args, **kwargs):
        raise NotImplementedError(_TELEMETRY)

    # ------------------------------------------------------------------
    def state_at(self, states: SimState, i: int) -> SimState:
        """Run ``i``'s SimState out of the stacked fleet state (views)."""
        return tree_map(lambda x: x[i], states)

    def summaries(self, states: SimState, name: str | None = None) -> list[RunSummary]:
        """One ``RunSummary`` per seed: one device-to-host copy per leaf for
        the whole fleet, then ``metrics.summarize`` row by row on the host."""
        host = tree_map(lambda x: x.cpu(), states)
        start = self.sim.conn_start.cpu().numpy()
        return [summarize(self.sim, self.state_at(host, i), name=name, conn_start=start)
                for i in range(self.n_runs)]


class FleetTelemetry:
    """The reference's host-side view of a fleet's telemetry sketches; it
    needs the telemetry port."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_TELEMETRY)
