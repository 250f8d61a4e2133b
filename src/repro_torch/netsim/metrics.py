"""Result summarization (counterpart of ``repro.netsim.metrics``).

``summarize`` builds a ``RunSummary`` from a run's final ``SimState`` on the
host, field for field as the reference does; ``summarize_sketch`` builds one
from a run's finalized telemetry channels (``repro_torch.netsim.telemetry``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.netsim import engine as E
from repro_torch.netsim.config import TICK_NS


@dataclasses.dataclass
class RunSummary:
    name: str
    lb: str
    n_conns: int
    completed: int
    runtime_ticks: int  # max FCT over completed conns (the paper's metric)
    runtime_us: float
    mean_fct_ticks: float
    p99_fct_ticks: float
    drops_cong: int
    drops_fail: int
    timeouts: int
    delivered: int
    injected: int
    ecn_marks: int
    unprocessed_events: int
    alloc_fails: int

    def row(self) -> str:
        return (
            f"{self.name},{self.lb},{self.completed}/{self.n_conns},"
            f"{self.runtime_us:.1f},{self.mean_fct_ticks:.0f},"
            f"{self.p99_fct_ticks:.0f},{self.drops_cong},{self.drops_fail},"
            f"{self.timeouts}"
        )


def summarize(sim, state, name: str | None = None, lb_name: str | None = None,
              n_conns: int | None = None, conn_start=None) -> RunSummary:
    """Summarize one run's final state (one device-to-host copy per leaf)."""
    done = state.c_done.cpu().numpy()
    done_tick = state.c_done_tick.cpu().numpy()
    start = np.asarray(
        conn_start if conn_start is not None else sim.conn_start.cpu().numpy()
    )
    stats = state.s_stats.cpu().numpy()
    fct = (done_tick - start)[done]
    runtime = int(done_tick[done].max()) if done.any() else -1
    return RunSummary(
        name=name or sim.wl.name,
        lb=lb_name or sim.lb.name,
        n_conns=n_conns if n_conns is not None else sim.wl.n_conns,
        completed=int(done.sum()),
        runtime_ticks=runtime,
        runtime_us=runtime * TICK_NS / 1000.0,
        mean_fct_ticks=float(fct.mean()) if len(fct) else float("nan"),
        p99_fct_ticks=float(np.percentile(fct, 99)) if len(fct) else float("nan"),
        drops_cong=int(stats[E.ST_DROPS_CONG]),
        drops_fail=int(stats[E.ST_DROPS_FAIL]),
        timeouts=int(stats[E.ST_TIMEOUTS]),
        delivered=int(stats[E.ST_DELIVERED]),
        injected=int(stats[E.ST_INJECTED]),
        ecn_marks=int(stats[E.ST_ECN]),
        unprocessed_events=int(stats[E.ST_UNPROC]),
        alloc_fails=int(stats[E.ST_ALLOC_FAIL]),
    )


def summarize_sketch(tel: dict, name: str, lb_name: str, n_conns: int) -> RunSummary:
    """Build a ``RunSummary`` from finalized telemetry channels
    (``TelemetryProgram.finalize_row``), as the reference does.  Needs the
    ``counters``, ``scalars`` and ``fct_hist`` channels (all in
    ``TelemetrySpec.default()``); every field but ``p99_fct_ticks`` equals
    ``summarize`` on the run's final state, and p99 is the sketch
    percentile (bin resolution)."""
    from repro_torch.netsim.telemetry import SUMMARY_CHANNEL_KEYS, sketch_percentile

    missing = SUMMARY_CHANNEL_KEYS - set(tel)
    if missing:
        raise ValueError(
            f"summarize_sketch needs channels {sorted(missing)}; "
            "include them in the TelemetrySpec (TelemetrySpec.default() does)"
        )
    c, s, h = tel["counters"], tel["scalars"], tel["fct_hist"]
    completed = s["fct_count"]
    runtime = s["done_tick_max"]
    return RunSummary(
        name=name,
        lb=lb_name,
        n_conns=n_conns,
        completed=completed,
        runtime_ticks=runtime,
        runtime_us=runtime * TICK_NS / 1000.0,
        mean_fct_ticks=s["mean_fct_ticks"],
        p99_fct_ticks=(sketch_percentile(h["counts"], h["edges"], 99, zeros=h["zeros"])
                       if completed else float("nan")),
        drops_cong=c["drops_cong"],
        drops_fail=c["drops_fail"],
        timeouts=c["timeouts"],
        delivered=c["delivered"],
        injected=c["injected"],
        ecn_marks=c["ecn_marks"],
        unprocessed_events=c["unprocessed"],
        alloc_fails=c["alloc_fails"],
    )
