"""Sweep engine: shape-bucketed multi-scenario fleets in a few tick loops
(counterpart of ``repro.netsim.sweep``).

The paper's headline figures sweep workloads × load balancers × seeds ×
failure schedules.  Run one after another, each cell pays the tick's fixed
cost, which on the card is the host issuing a few hundred small launches
per tick.  This module batches *heterogeneous* cells instead, as the
reference does:

  1. **Quantization** — cells are described by their padded static shapes
     ``(ticks, adaptive, NC, MSG, F, W)``: conn counts and message-bitmap
     widths round up to powers of two, failure schedules drop events that
     are provably dead before the horizon (``failures.truncate_dead``) and
     pad to the bucket max, watch lists pad to the bucket max.  Within a
     bucket every row has the same shapes, so the whole bucket steps in one
     tick loop over a leading row axis (``Simulator.step_rows``), each
     kernel one launch per tick whatever the row count.
  2. **Cost-aware packing** (``pack``) — pure, host-side, inspectable, and
     the reference's plan for the same inputs: shape groups merge under
     ``PackerConfig.waste_budget``, large groups split into sub-buckets
     that share one program, rows pad to a multiple of the device count.
  3. **Neutral padding** — padded conns never start (start tick
     ``NEVER_TICK``), padded failure rows are inert, and the derived static
     sizes are pinned (``SimConfig.msg_slots`` / ``conns_per_host`` /
     ``failure_slots``) so that the serial reference (``serial_sim``) has the
     same shapes: every sweep row is bit-identical to ``Simulator.run`` on
     it, and to the reference's sweep row (tests/test_torch_sweep.py).
  4. **Per-row horizons** — a bucket that fuses cells with different tick
     horizons runs to the longest; each row is frozen at its own.  The tick
     never mutates the state it is given (``Simulator.step_rows``), so a
     row's state at its horizon stays valid while it is referenced: the
     state object is kept at each horizon tick (with a copy of those rows'
     telemetry carry, which is updated in place), every row keeps stepping,
     and at the end of each chunk the frozen rows are copied back, one
     ``torch.where`` per leaf per distinct horizon.  A tick on which no
     row's horizon falls does nothing more than an unmasked bucket's tick.
  5. **LB dispatch** — cells that differ only in load balancer share the
     bucket through ``SwitchLB``: one branch index per row selects the
     variant (every variant steps every row, each row keeps its own), so
     the ECMP/OPS/REPS columns share one tick and the ``reps_tick`` kernel
     stays one launch per tick.  In-network adaptive LBs change the
     routing function (a static property) and never merge with endpoint
     LBs.
  6. **Chunked execution** — ``collect="none"`` makes no per-tick output,
     ``"full"`` streams each chunk's traces to the host, ``"summary"``
     folds a ``TelemetrySpec`` into every tick on the device
     (``repro_torch.netsim.telemetry``); the quiescence early exit stops a
     bucket at the first chunk boundary where every row has reached its
     fixed point (one device-to-host read per chunk, never per tick),
     without changing any reported metric.  ``trace=TraceSpec(...)``
     (summary mode) also carries the flight recorder's ring per row
     (``repro_torch.netsim.tracer``), stepped through ``step_events_rows``
     and frozen with the telemetry carry; ``SweepResult.flight_for``
     decodes a row's events.  Tracing is observation-only.
  7. **Resumable chunks** — ``bucket_carry``, ``chunk_runner``,
     ``run_chunk`` and ``finalize_bucket`` are the building blocks ``run``
     drives: any chunking of ``[0, ticks)`` gives the same result.

Scale mode (``SimConfig(conn_sharding=True)``: the sparse active set and
the lifetime-sized packet table) runs through the same buckets on the one
card (``conn_devices=1``).  Not ported yet: the row-sharded device mesh
(``devices`` other than one card) and the connection axis sharded over
several cards (``conn_devices > 1``), both multi-GPU; each raises
``NotImplementedError``.

Example (on the card; pass ``device="cpu"`` for the plain versions):

    cases = [SweepCase(f"fig02/{w}/{lb}", wl, lb, ticks=4000)
             for w, wl in wls.items() for lb in ("ecmp", "ops", "reps")]
    eng = SweepEngine(cfg, cases)
    print(eng.plan.describe())
    result = eng.run(collect="summary", early_exit=True)
    for name, summaries in result.summaries().items(): ...
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.load_balancers import SwitchLB, make_lb
from repro_torch.device import resolve_device
from repro_torch.netsim.config import SimConfig
from repro_torch.netsim.engine import (
    FailureSchedule, ScenarioArrays, Simulator, SimState, TickTrace, Workload,
    tree_map,
)
from repro_torch.netsim.failures import truncate_dead
from repro_torch.netsim.metrics import RunSummary, summarize, summarize_sketch
from repro_torch.netsim.telemetry import SUMMARY_CHANNEL_KEYS, TelemetrySpec
from repro_torch.netsim.tracer import TraceSpec

# padded conns start here: far beyond any sweep horizon, still well inside
# int32 so `now >= start` arithmetic cannot wrap.
NEVER_TICK = 2**29


def _pow2(n: int) -> int:
    return int(2 ** np.ceil(np.log2(max(int(n), 1))))


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One cell of a sweep grid: a scenario structure plus its seeds."""

    name: str
    workload: Workload
    lb: str  # load-balancer registry name
    ticks: int
    lb_kwargs: dict = dataclasses.field(default_factory=dict)
    failures: FailureSchedule | None = None
    watch_queues: Any = None  # None = topology default
    seeds: tuple[int, ...] = (0,)


# ---------------------------------------------------------------------------
# Cost-aware bucket packer.  Pure host-side planning over quantized cell
# shapes — no torch, no Simulator construction — so property tests can hammer
# it with random grids (tests/test_sweep.py).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackerConfig:
    """Knobs for ``pack``.

    * ``max_rows_per_bucket`` — split threshold: a bucket's (cells × seeds)
      row count beyond this splits into sub-buckets sharing one program
      (one simulator and its prepared row constants).  A single cell larger than the threshold stays atomic (one
      oversized bucket).
    * ``waste_budget`` — max fractional padded-cost overhead a merged
      bucket may carry over the sum of its members' native costs
      (``BucketPlan.merge_waste``).  0 disables all padding-for-merging
      but still fuses bit-identical shapes.
    * ``merge`` — disable to reproduce pure shape quantization (one bucket
      per distinct quantized shape, the pre-packer behavior).
    """

    max_rows_per_bucket: int = 1024
    waste_budget: float = 0.25
    merge: bool = True


@dataclasses.dataclass(frozen=True)
class CellShape:
    """What the packer sees of a cell: quantized static shapes + row count.

    ``nc``/``msg``/``f``/``w`` are the cell's *own* padded sizes (pow2
    conns, pow2 message bitmap, live failure rows, watch rows); ``rows`` is
    its seed count.  Merging never mutates a CellShape — native costs are
    always measured on these original shapes.

    ``nc_exact`` is the unquantized conn count.  Grouping and cost compare
    the pow2 ``nc`` (so near-sized cells land together), but the bucket is
    finally sized to the *max exact* conn count of its members: conn
    padding is visible to spraying LBs through their per-conn random draw
    shapes (threefry pairs counter i with i + n/2, so a (480,) draw and
    a (512,) draw differ everywhere), and shrink-to-fit keeps the largest
    cell of every bucket — and any solo-shape figure column — bit-identical
    to a *raw* unpadded serial run, not just to the padded reference.
    """

    name: str
    ticks: int
    adaptive: bool
    nc: int
    msg: int
    f: int
    w: int
    rows: int
    nc_exact: int = 0  # 0 = same as nc

    @property
    def key(self) -> tuple:
        return (self.ticks, self.adaptive, self.nc, self.msg, self.f, self.w)


def est_row_tick_cost(
    cfg: SimConfig, nc: int, msg: int, f: int, w: int
) -> float:
    """Estimated cost of one row-tick at the given padded shapes.

    The tick body is gather/scatter-bound (engine.py header), so the proxy
    counts array footprint touched per tick rather than FLOPs: the packed
    packet table (NP slots, pow2 of conns × max cwnd + host slack), the
    per-conn message bitmaps (NC × MSG, touched via event scatters at ~1/8
    density), the feedback/delivery segment tables (MAX_EV ≈ 3·NH events ×
    NC+1 segments), and the linear schedule/watch rows.  Only *relative*
    cost matters — the packer compares merged vs native sums of this
    estimate (or of the measured-cost model, see ``measured_costs_from_bench``).
    """
    np_slots = _pow2(nc * cfg.max_cwnd_pkts + 4 * cfg.n_hosts + 64)
    max_ev = 3 * cfg.n_hosts
    return float(np_slots + nc * msg / 8.0 + max_ev * (nc + 1) / 8.0 + f + w)


def measured_costs_from_bench(path_or_rows) -> dict:
    """Harvest the packer's measured-cost feedback from a benchmark file.

    Args:
        path_or_rows: path to a ``BENCH_netsim.json`` (or its already-loaded
            ``rows`` dict).  The PackPlan-keyed ``{fig}/bucket/*`` rows that
            ``benchmarks/common.figure_grid`` emits carry ``bucket_key =
            [ticks, adaptive, nc, msg, f, w]`` next to the *measured*
            ``measured_row_tick_us`` wall-clock of that bucket's scan.

    Returns:
        ``{(adaptive, pow2(nc), msg, f, w): mean measured_row_tick_us}`` —
        the per-row-tick cost is horizon-independent, so ``ticks`` is
        dropped; ``nc`` quantizes to the pow2 grouping grid because bucket
        keys record the shrink-to-fit *exact* conn count while the packer's
        merge decisions compare pow2-quantized shapes.  Multiple samples of
        one shape (several figures / sub-buckets) average.  Missing or
        malformed files yield ``{}`` (the packer then falls back to
        ``est_row_tick_cost`` everywhere).
    """
    rows = path_or_rows
    if not isinstance(rows, dict):
        import json

        try:
            with open(path_or_rows) as fh:
                rows = json.load(fh).get("rows", {})
        except (OSError, ValueError, AttributeError):
            return {}
    acc: dict[tuple, list] = {}
    if not isinstance(rows, dict):
        return {}
    for name, rec in rows.items():
        if "/bucket/" not in str(name) or not isinstance(rec, dict):
            continue
        key = rec.get("bucket_key")
        us = rec.get("measured_row_tick_us")
        try:
            _t, ad, nc, msg, f, w = key
            k = (bool(ad), _pow2(nc), int(msg), int(f), int(w))
            us = float(us)
        except (TypeError, ValueError):  # malformed row: skip, don't abort
            continue
        if us > 0:
            acc.setdefault(k, []).append(us)
    return {k: sum(v) / len(v) for k, v in acc.items()}


def _cost_model(cfg: SimConfig, measured: dict | None):
    """Per-row-tick cost function for ``pack``: measured µs where a shape
    was benchmarked, the footprint estimate *calibrated to µs* elsewhere
    (scale = median measured/estimate ratio over the measured keys, so
    mixing the two inside one merge comparison stays unit-consistent).
    Deterministic: pure arithmetic over the sorted measured dict."""
    if not measured:
        return lambda ad, nc, msg, f, w: est_row_tick_cost(cfg, nc, msg, f, w)
    ratios = sorted(
        us / max(est_row_tick_cost(cfg, *k[1:]), 1e-9)
        for k, us in measured.items()
    )
    scale = ratios[len(ratios) // 2]

    def cost(ad, nc, msg, f, w):
        hit = measured.get((ad, nc, msg, f, w))
        if hit is None:
            hit = measured.get((ad, _pow2(nc), msg, f, w))
        if hit is not None:
            return hit
        return scale * est_row_tick_cost(cfg, nc, msg, f, w)

    return cost


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One planned bucket: a set of cells sharing padded shapes + horizon.

    ``key = (ticks, adaptive, nc, msg, f, w)`` is the padded union shape;
    ``group`` identifies the split family — buckets with equal ``group``
    share padded shapes *and* ``n_padded_rows`` and therefore one program.  ``native_cost`` sums the members' costs at their own
    quantized shapes/horizons, so ``merge_waste`` isolates the padding
    overhead the packer accepted to fuse them.
    """

    key: tuple
    cells: tuple[str, ...]
    group: int
    n_rows: int
    n_padded_rows: int
    n_devices: int
    est_row_cost: float  # one padded row over the full bucket horizon
    native_cost: float

    @property
    def ticks(self) -> int:
        return self.key[0]

    @property
    def est_cost(self) -> float:
        return self.n_rows * self.est_row_cost

    @property
    def merge_waste(self) -> float:
        """Fractional padded-cost overhead from shape/horizon merging
        (row padding excluded — see ``pad_rows``)."""
        return self.est_cost / max(self.native_cost, 1e-9) - 1.0

    @property
    def pad_rows(self) -> int:
        return self.n_padded_rows - self.n_rows

    @property
    def device_rows(self) -> tuple[int, ...]:
        """Rows per device (the padded row axis splits evenly; rows of one
        bucket cost the same, so equal rows ⇒ balanced estimated tick
        cost)."""
        per = self.n_padded_rows // self.n_devices
        return (per,) * self.n_devices


@dataclasses.dataclass(frozen=True)
class PackPlan:
    """The packer's full output — inspect via ``SweepEngine.plan``.

    A pure host-side dataclass tree (no tensors): ``buckets`` is the
    ordered tuple of :class:`BucketPlan` rows the engine will materialize,
    ``n_devices`` the mesh width every bucket's rows were padded for, and
    ``packer`` the :class:`PackerConfig` that produced the plan.

    Invariants (property-tested): cells covered exactly once across
    ``buckets``; per split-group aggregate ``merge_waste`` ≤ the packer's
    budget (``group_merge_waste()``); every ``n_padded_rows`` divisible by
    ``n_devices``.  Plans are deterministic in (cfg, shapes, packer,
    n_devices, measured_costs) — replanning with identical inputs yields
    an identical (``==``) plan, which is what lets benchmark files key
    rows by plan shape.  ``describe()`` renders the human-readable form.
    """

    buckets: tuple[BucketPlan, ...]
    n_devices: int
    packer: PackerConfig

    @property
    def n_cells(self) -> int:
        return sum(len(b.cells) for b in self.buckets)

    @property
    def n_rows(self) -> int:
        return sum(b.n_rows for b in self.buckets)

    @property
    def n_padded_rows(self) -> int:
        return sum(b.n_padded_rows for b in self.buckets)

    @property
    def n_groups(self) -> int:
        return len({b.group for b in self.buckets})

    @property
    def merge_waste(self) -> float:
        native = sum(b.native_cost for b in self.buckets)
        est = sum(b.est_cost for b in self.buckets)
        return est / max(native, 1e-9) - 1.0

    def group_merge_waste(self) -> dict[int, float]:
        """Per split-group aggregate waste — the level the budget is
        enforced at (an individual sub-bucket holding only the group's
        shortest-horizon cells can sit above it)."""
        est: dict[int, float] = {}
        native: dict[int, float] = {}
        for b in self.buckets:
            est[b.group] = est.get(b.group, 0.0) + b.est_cost
            native[b.group] = native.get(b.group, 0.0) + b.native_cost
        return {
            g: est[g] / max(native[g], 1e-9) - 1.0 for g in est
        }

    def describe(self) -> str:
        lines = [
            f"PackPlan: {self.n_cells} cells -> {len(self.buckets)} buckets "
            f"({self.n_groups} compiled programs, {self.n_devices} devices, "
            f"waste {self.merge_waste:+.1%})"
        ]
        for b in self.buckets:
            t, ad, nc, msg, f, w = b.key
            lines.append(
                f"  g{b.group} ticks={t} adaptive={int(ad)} NC={nc} MSG={msg} "
                f"F={f} W={w} rows={b.n_rows}+{b.pad_rows}pad "
                f"waste={b.merge_waste:+.1%} cells={list(b.cells)}"
            )
        return "\n".join(lines)


@dataclasses.dataclass
class _Group:
    shapes: list[CellShape]

    def key(self) -> tuple:
        ks = [s.key for s in self.shapes]
        return (
            max(k[0] for k in ks), ks[0][1], max(k[2] for k in ks),
            max(k[3] for k in ks), max(k[4] for k in ks),
            max(k[5] for k in ks),
        )

    def fit_key(self) -> tuple:
        """The bucket's final key: NC shrunk to the members' max *exact*
        conn count (see CellShape.nc_exact) — quantized NC is a grouping /
        cost artifact, not a shape the scan has to pay (or perturb RNG
        streams) for."""
        k = self.key()
        nc_fit = max(max(s.nc_exact or s.nc, 1) for s in self.shapes)
        return (k[0], k[1], nc_fit, *k[3:])

    def rows(self) -> int:
        return sum(s.rows for s in self.shapes)


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def pack(
    cfg: SimConfig,
    shapes: Sequence[CellShape],
    packer: PackerConfig = PackerConfig(),
    n_devices: int = 1,
    measured_costs: dict | None = None,
) -> PackPlan:
    """Plan buckets for quantized cell shapes (pure; deterministic).

    Args:
        cfg: the sweep's base :class:`SimConfig` (only static sizing fields
            feed the cost model).
        shapes: one :class:`CellShape` per cell — quantized padded shapes
            plus the cell's seed-row count.  Names must be unique.
        packer: merge/split knobs, see :class:`PackerConfig`.
        n_devices: sweep mesh size; bucket rows pad to a multiple of it.
        measured_costs: optional ``{(adaptive, nc, msg, f, w): µs}`` map of
            *measured* per-row-tick wall-clock (the PackPlan-keyed
            ``{fig}/bucket/*`` rows of ``BENCH_netsim.json`` — build it with
            :func:`measured_costs_from_bench`).  Where a candidate shape was
            benchmarked its measured cost replaces the footprint estimate in
            every merge comparison; unbenchmarked shapes fall back to the
            estimate calibrated to µs (median measured/estimate ratio), so
            the two are unit-compatible.  ``None``/``{}`` = pure estimate.

    Returns:
        A :class:`PackPlan` — a pure dataclass tree (no tensors) that
        ``SweepEngine`` materializes and that tests/benchmarks assert on.

    Invariants (property-tested in tests/test_sweep.py):
      * every cell lands in exactly one bucket;
      * ``n_rows <= max(max_rows_per_bucket, largest cell) + n_devices - 1``
        for every bucket (cells are atomic; capacities are device-rounded);
      * aggregate ``merge_waste <= waste_budget`` for every split group
        (``PackPlan.group_merge_waste`` — the merge decision's level; a
        single sub-bucket of a heterogeneous group can sit above it) under
        whichever cost model (estimated or measured) planned it;
      * ``n_padded_rows`` is a multiple of ``n_devices`` and every device
        is assigned exactly ``n_padded_rows / n_devices`` rows;
      * planning is deterministic: identical inputs (including the
        ``measured_costs`` dict) reproduce the identical plan.

    Note on bit-parity: the plan decides each bucket's padded conn count
    (shrink-to-fit to its members' max *exact* conn count).  Conn padding
    is RNG-visible to spraying load balancers — threefry draws are
    **not prefix-stable** (a ``(480,)`` uniform draw shares no prefix with
    a ``(512,)`` draw), so two plans that bucket a cell differently can
    both be *self*-consistent yet produce different per-cell streams.
    Every plan is bit-identical to its own ``serial_sim`` reference; only
    cells whose exact conn count equals their bucket's fit size are
    additionally bit-identical to a *raw* unpadded run.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if not shapes:
        raise ValueError("need at least one cell")
    names = [s.name for s in shapes]
    if len(set(names)) != len(names):
        raise ValueError("cell names must be unique")
    cost_fn = _cost_model(cfg, measured_costs)

    def _cell_cost(s: CellShape) -> float:
        return s.rows * s.ticks * cost_fn(s.adaptive, s.nc, s.msg, s.f, s.w)

    # 1. exact-shape grouping (insertion order kept for determinism)
    by_key: dict[tuple, _Group] = {}
    for s in shapes:
        by_key.setdefault(s.key, _Group(shapes=[])).shapes.append(s)
    groups = list(by_key.values())

    def native(g: _Group) -> float:
        return sum(_cell_cost(s) for s in g.shapes)

    def est(key: tuple, rows: int) -> float:
        t, ad, nc, msg, f, w = key
        return rows * t * cost_fn(ad, nc, msg, f, w)

    # 2. greedy lowest-waste pairwise merging under the budget.  Group
    #    key/rows/native are additive under merge, so they are memoized and
    #    updated incrementally — the pair search is O(1) per pair instead
    #    of re-summing per-cell costs.
    keys = [g.key() for g in groups]
    rows = [g.rows() for g in groups]
    natives = [native(g) for g in groups]

    def merged_key(a: tuple, b: tuple) -> tuple:
        return (
            max(a[0], b[0]), a[1], max(a[2], b[2]), max(a[3], b[3]),
            max(a[4], b[4]), max(a[5], b[5]),
        )

    while packer.merge and len(groups) > 1:
        best = None  # (waste, i, j)
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                if keys[i][1] != keys[j][1]:
                    continue  # adaptive routing is a static property
                k = merged_key(keys[i], keys[j])
                waste = est(k, rows[i] + rows[j]) / max(
                    natives[i] + natives[j], 1e-9
                ) - 1.0
                if waste <= packer.waste_budget and (
                    best is None or waste < best[0] - 1e-12
                ):
                    best = (waste, i, j)
        if best is None:
            break
        _, i, j = best
        groups[i] = _Group(shapes=groups[i].shapes + groups[j].shapes)
        keys[i] = merged_key(keys[i], keys[j])
        rows[i] += rows[j]
        natives[i] += natives[j]
        del groups[j], keys[j], rows[j], natives[j]

    # 3. split oversized groups into equal-capacity sub-buckets that share
    #    one program (same shapes AND same padded row count)
    buckets: list[BucketPlan] = []
    for gid, g in enumerate(groups):
        key = g.fit_key()
        total = g.rows()
        max_cell = max(s.rows for s in g.shapes)
        threshold = max(packer.max_rows_per_bucket, max_cell)
        n_sub = -(-total // threshold)
        target = max(-(-total // n_sub), max_cell)
        cap = _pad_to(target, n_devices)
        if n_sub == 1:
            order = list(g.shapes)  # keep submission order
        else:
            order = sorted(g.shapes, key=lambda s: (-s.rows, s.name))
        bins: list[list[CellShape]] = []
        fill: list[int] = []
        for s in order:
            for b_i, used in enumerate(fill):
                if used + s.rows <= cap:
                    bins[b_i].append(s)
                    fill[b_i] += s.rows
                    break
            else:
                bins.append([s])
                fill.append(s.rows)
        shared_pad = (
            _pad_to(max(fill), n_devices) if len(bins) > 1 else None
        )
        row_cost = key[0] * cost_fn(key[1], *key[2:])
        for cells, used in zip(bins, fill):
            buckets.append(
                BucketPlan(
                    key=key,
                    cells=tuple(s.name for s in cells),
                    group=gid,
                    n_rows=used,
                    n_padded_rows=(
                        shared_pad
                        if shared_pad is not None
                        else _pad_to(used, n_devices)
                    ),
                    n_devices=n_devices,
                    est_row_cost=row_cost,
                    native_cost=sum(_cell_cost(s) for s in cells),
                )
            )
    return PackPlan(
        buckets=tuple(buckets), n_devices=n_devices, packer=packer
    )


# ---------------------------------------------------------------------------
# Engine-side materialization of a plan.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Engine-side materialization of a plan.
# ---------------------------------------------------------------------------


def _canon_lb_kwargs(case: SweepCase, cfg: SimConfig) -> dict:
    """LB kwargs with harness defaults resolved — keying on the raw kwargs
    would give `{}` and `{"evs_size": cfg.evs_size}` distinct SwitchLB
    branches, and every redundant branch costs a full extra LB evaluation
    per tick (every variant steps every row)."""
    kw = dict(case.lb_kwargs)
    kw.setdefault("evs_size", cfg.evs_size)
    return kw


def _variant_key(case: SweepCase, cfg: SimConfig) -> tuple:
    return (case.lb, tuple(sorted(_canon_lb_kwargs(case, cfg).items())))


def _pad_workload(wl: Workload, nc: int, n_hosts: int) -> Workload:
    """Pad the conn table to ``nc`` rows with inert connections: they never
    start and depend on nothing.  Pad conns fill the *least-loaded* hosts
    first, so whenever the padding fits into existing per-host slack the
    conns_per_host pin equals the unpadded auto width — and the padded row
    stays bit-identical to a raw (unpinned) serial run, not just to the
    pinned serial reference."""
    extra = nc - wl.n_conns
    if extra == 0:
        return wl
    if extra < 0:
        raise ValueError(f"cannot pad a {wl.n_conns}-conn workload down to {nc}")
    counts = np.bincount(wl.src.astype(np.int64), minlength=n_hosts).astype(np.int64)
    pad_src = np.empty((extra,), np.int32)
    for i in range(extra):
        h = int(np.argmin(counts))  # stable: lowest host id wins ties
        pad_src[i] = h
        counts[h] += 1
    return Workload(
        src=np.concatenate([wl.src.astype(np.int32), pad_src]),
        dst=np.concatenate([wl.dst.astype(np.int32), (pad_src + 1) % n_hosts]).astype(np.int32),
        msg_pkts=np.concatenate([wl.msg_pkts.astype(np.int32), np.ones((extra,), np.int32)]),
        start=np.concatenate([wl.start.astype(np.int32),
                              np.full((extra,), NEVER_TICK, np.int32)]),
        dep=np.concatenate([wl.dep.astype(np.int32), np.full((extra,), -1, np.int32)]),
        name=wl.name,
    )


def _host_conns(wl: Workload, n_hosts: int, cph: int) -> np.ndarray:
    """host -> local conn table, same layout the engine builds (-1 padded)."""
    hc = np.full((n_hosts, cph), -1, np.int32)
    fill = np.zeros((n_hosts,), np.int32)
    for c in range(wl.n_conns):
        h = int(wl.src[c])
        hc[h, fill[h]] = c
        fill[h] += 1
    return hc


def _pad_watch(watch: np.ndarray, w: int) -> np.ndarray:
    watch = np.asarray(watch, np.int32)
    extra = w - len(watch)
    if extra < 0:
        raise ValueError(f"cannot pad a {len(watch)}-queue watch list down to {w}")
    if extra == 0:
        return watch
    fill = watch[-1] if len(watch) else 0
    return np.concatenate([watch, np.full((extra,), fill, np.int32)])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class _Cell:
    case: SweepCase
    padded_wl: Workload
    padded_fs: FailureSchedule
    padded_watch: np.ndarray
    branch: int
    rows: list[int] = dataclasses.field(default_factory=list)  # per seed


@dataclasses.dataclass
class _Program:
    """One tick family: all sub-buckets of a split group share it (identical
    padded shapes, padded row count, SwitchLB variant set), and with it one
    simulator, its per-row constants and telemetry layouts."""

    group: int
    cfg: SimConfig  # shape-pinned bucket config
    lb: SwitchLB
    sim: Simulator
    sim_ticks: int  # the group's bucket horizon (max member horizon)
    masked: bool  # rows carry heterogeneous horizons
    variant_order: list  # one (lb, kwargs) key per SwitchLB branch
    padded_wls: dict  # cell name -> group-padded Workload
    chunk_fns: dict = dataclasses.field(default_factory=dict)  # (n, collect, spec, trace) -> fn
    tel_progs: dict = dataclasses.field(default_factory=dict)  # spec -> prog
    trc_progs: dict = dataclasses.field(default_factory=dict)  # TraceSpec -> prog


@dataclasses.dataclass
class _Bucket:
    plan: BucketPlan
    program: _Program
    cells: list[_Cell]
    n_rows: int
    # stacked per-row inputs, on the engine's device
    keys: torch.Tensor  # (R, 2)
    scn: ScenarioArrays  # leaves (R, ...)
    branch_idx: np.ndarray  # (R,)
    horizons: np.ndarray  # (R,) per-row tick horizon
    horizons_t: torch.Tensor  # (R,) int32, the same on the device
    # filled by run()
    final_state: Any = None  # SimState of CPU tensors, leaves (n_rows, ...)
    traces: Any = None  # TickTrace of CPU tensors (ticks, n_rows, ...) or None
    telemetry: Any = None  # (n_rows, size) int32 numpy sketch carries or None
    tel_prog: Any = None  # TelemetryProgram that owns `telemetry`'s layout
    trace_rows: Any = None  # (n_rows, size) int32 numpy flight-ring carries or None
    trc_prog: Any = None  # TracerProgram that owns `trace_rows`'s layout
    exec_wall_s: float = 0.0
    compile_wall_s: float = 0.0  # set-up: the t=0 carry (nothing is compiled)
    ticks_run: int = 0  # == ticks unless early exit fired sooner

    @property
    def key(self) -> tuple:
        return self.plan.key

    @property
    def ticks(self) -> int:
        return self.plan.ticks

    @property
    def cfg(self) -> SimConfig:
        return self.program.cfg

    @property
    def lb(self) -> SwitchLB:
        return self.program.lb

    @property
    def sim(self) -> Simulator:
        return self.program.sim


class SweepResult:
    """Per-cell access to a finished sweep (every array already on the
    host)."""

    def __init__(self, engine: "SweepEngine"):
        self._engine = engine
        self.buckets = engine.buckets
        self.plan = engine.plan
        self.exec_wall_s = sum(b.exec_wall_s for b in self.buckets)
        self.compile_wall_s = sum(b.compile_wall_s for b in self.buckets)

    def _find(self, name: str) -> tuple[_Bucket, _Cell]:
        for b in self.buckets:
            for c in b.cells:
                if c.case.name == name:
                    return b, c
        raise KeyError(name)

    def state_for(self, name: str, seed_idx: int = 0) -> SimState:
        b, c = self._find(name)
        row = c.rows[seed_idx]
        return tree_map(lambda x: x[row], b.final_state)

    def trace_for(self, name: str, seed_idx: int = 0) -> TickTrace:
        b, c = self._find(name)
        if b.traces is None:
            raise ValueError("run with collect='full' to keep traces")
        row = c.rows[seed_idx]
        # rows of a horizon-merged bucket freeze at their own horizon; the
        # trace past it is discarded work, so expose only the cell's window
        return TickTrace(*(f[: c.case.ticks, row] for f in b.traces))

    def flight_for(self, name: str, seed_idx: int = 0, since: int = 0) -> dict:
        """Decoded flight-recorder events of one cell row (run with a
        ``trace=TraceSpec(...)``): ``{seq, tick, code, value, cursor, lost,
        first_drop_tick, first_redeliver_tick}``, see
        ``tracer.TracerProgram.decode_row``."""
        b, c = self._find(name)
        if b.trace_rows is None:
            raise ValueError(
                "no flight-recorder events were collected for this sweep; "
                "run with trace=TraceSpec(...)"
            )
        return b.trc_prog.decode_row(b.trace_rows[c.rows[seed_idx]], since)

    def telemetry_for(self, name: str, seed_idx: int = 0) -> dict:
        """Finalized sketch channels for one cell row.

        Args:
            name: the cell's ``SweepCase.name``.
            seed_idx: index into the cell's ``seeds`` tuple (not the seed
                value itself).

        Returns:
            ``{channel key: finalized dict}`` as produced by each channel's
            ``finalize``.  Finalization uses the cell's *own* horizon (rows
            of a horizon-merged bucket froze bit-exactly there), so the
            result is identical whether or not the cell shared its bucket.

        Raises:
            ValueError: if the sweep did not run with ``collect="summary"``.
            KeyError: unknown cell name.
        """
        b, c = self._find(name)
        if b.telemetry is None:
            raise ValueError(
                "no telemetry sketches were collected for this sweep; "
                "run with collect='summary'"
            )
        return b.tel_prog.finalize_row(b.telemetry[c.rows[seed_idx]], c.case.ticks)

    def summaries(self, source: str = "auto") -> dict[str, list[RunSummary]]:
        """Per-cell summaries (one per seed).

        ``source="state"`` builds them from each bucket's final state;
        ``"sketch"`` from the telemetry sketches (summary mode) — equal
        counters/completions/runtime/mean, p99 to bin resolution; ``"auto"``
        prefers sketches when they were collected with the channels a
        RunSummary needs (custom specs without them fall back to the state
        path, which is always available).
        """
        if source not in ("auto", "state", "sketch"):
            raise ValueError(f"source must be 'auto', 'state' or 'sketch', got {source!r}")
        out: dict[str, list[RunSummary]] = {}
        for b in self.buckets:
            sketch = (
                b.telemetry is not None and SUMMARY_CHANNEL_KEYS <= b.tel_prog.channel_keys
                if source == "auto"
                else source == "sketch"
            )
            for c in b.cells:
                variant = b.lb.variants[c.branch]
                if sketch:
                    if b.telemetry is None:
                        raise ValueError(
                            "no telemetry sketches were collected; run "
                            "with collect='summary' for sketch summaries"
                        )
                    out[c.case.name] = [
                        summarize_sketch(
                            b.tel_prog.finalize_row(b.telemetry[row], c.case.ticks),
                            name=c.case.name, lb_name=variant.name,
                            n_conns=c.case.workload.n_conns,
                        )
                        for row in c.rows
                    ]
                else:
                    out[c.case.name] = [
                        summarize(
                            b.sim, tree_map(lambda x, r=row: x[r], b.final_state),
                            name=c.case.name, lb_name=variant.name,
                            n_conns=c.case.workload.n_conns, conn_start=c.padded_wl.start,
                        )
                        for row in c.rows
                    ]
        return out


class SweepEngine:
    """Packs a list of SweepCases into cost-aware buckets and runs each as
    one tick loop over its rows, on one device.

    ``device``: the card unless ``"cpu"`` is asked for (the plain versions
    of the kernels run there).  ``devices`` takes ``"auto"``, ``None`` or 1
    (the one device; a row mesh over several cards is not ported yet),
    ``conn_devices`` only 1 (scale mode runs on one card), and
    ``kernels_backend`` only ``None``: the port has one kernel path per
    device, and the device picks it.  ``measured_costs`` feeds the packer's
    measured-cost model, see ``pack`` / ``measured_costs_from_bench``.
    """

    def __init__(
        self,
        cfg: SimConfig,
        cases: Sequence[SweepCase],
        devices: int | str | None = "auto",
        min_conn_bucket: int = 8,
        packer: PackerConfig | None = None,
        kernels_backend: str | None = None,
        measured_costs: dict | None = None,
        min_failure_slots: int = 0,
        conn_devices: int = 1,
        device=None,
    ):
        # ``min_failure_slots`` floors every cell's quantized failure-row
        # count (pow2-rounded like the natural size): headroom for live
        # failure injection into the reserved inert rows without a shape
        # change, as the reference's soak runtime uses it.
        self.min_failure_slots = int(min_failure_slots)
        self.cfg = cfg
        self.cases = list(cases)
        if not self.cases:
            raise ValueError("need at least one case")
        self.conn_devices = max(1, int(conn_devices))
        if self.conn_devices > 1:
            raise NotImplementedError(
                f"conn_devices={self.conn_devices}: sharding the connection axis over "
                "several cards (multi-GPU torch.distributed) is not ported yet; scale "
                "mode (conn_sharding=True) runs with conn_devices=1 (ROADMAP.md, queue 1 "
                "item 12, multi-GPU)"
            )
        if devices not in ("auto", None, 1):
            raise NotImplementedError(
                f"devices={devices!r}: the port runs a sweep on one device; a row mesh "
                "over several cards is not ported yet (ROADMAP.md, queue 1 item 12)"
            )
        if kernels_backend is not None:
            raise ValueError(
                f"kernels_backend={kernels_backend!r}: the port has one kernel path per "
                "device, and the device picks it (pass device=...)"
            )
        self.device = resolve_device(device)
        self.n_devices = 1
        self.kernels_backend = None
        self.min_conn_bucket = min_conn_bucket
        self.packer = packer or PackerConfig()
        self._default_watch_arr = self._default_watch()
        self.plan = pack(
            cfg,
            [self._quantize(c) for c in self.cases],
            self.packer,
            self.n_devices,
            measured_costs=measured_costs,
        )
        self.programs: dict[int, _Program] = {}
        self.buckets = self._build_buckets()

    # ------------------------------------------------------------------
    def _default_watch(self) -> np.ndarray:
        from repro_torch.netsim.topology import Topology

        topo = Topology.build(self.cfg)
        return np.asarray(topo.t0_up_queues(0)[: self.cfg.n_watch_queues], np.int32)

    def _watch_for(self, case: SweepCase) -> np.ndarray:
        if case.watch_queues is None:
            return self._default_watch_arr
        return np.asarray(case.watch_queues, np.int32)

    def _live_failures(self, case: SweepCase) -> FailureSchedule:
        return truncate_dead(case.failures or FailureSchedule.none(), case.ticks)

    def _quantize(self, case: SweepCase) -> CellShape:
        cfg = self.cfg
        variant = make_lb(case.lb, **_canon_lb_kwargs(case, cfg))
        wl = case.workload
        msg_max = int(wl.msg_pkts.max()) if wl.n_conns else 1
        nc_exact = _pad_to(max(wl.n_conns, 1), self.conn_devices)
        return CellShape(
            name=case.name,
            ticks=case.ticks,
            adaptive=variant.switch_adaptive,
            nc=_pow2(max(wl.n_conns, self.min_conn_bucket)),
            msg=int(min(cfg.max_msg_pkts, max(_pow2(max(msg_max, 2)), 2))),
            f=_pow2(max(len(self._live_failures(case)), 1, self.min_failure_slots)),
            w=_pow2(max(len(self._watch_for(case)), 1)),
            rows=len(case.seeds),
            nc_exact=nc_exact,
        )

    # ------------------------------------------------------------------
    def _build_buckets(self) -> list[_Bucket]:
        by_name = {c.name: c for c in self.cases}
        # group-level shape/variant context (shared by all sub-buckets)
        group_cases: dict[int, list[SweepCase]] = {}
        for bp in self.plan.buckets:
            group_cases.setdefault(bp.group, []).extend(by_name[n] for n in bp.cells)
        for gid, members in group_cases.items():
            self.programs[gid] = self._build_program(
                gid, next(bp for bp in self.plan.buckets if bp.group == gid), members)
        return [self._build_bucket(bp, by_name) for bp in self.plan.buckets]

    def _build_program(self, gid: int, bp: BucketPlan, members: list[SweepCase]) -> _Program:
        ticks_b, _adaptive, nc_b, msg_b, f_b, _w_b = bp.key
        cfg = self.cfg

        # one SwitchLB branch per distinct (lb name, kwargs) spec
        variant_order: list[tuple] = []
        variants = []
        for case in members:
            vk = _variant_key(case, cfg)
            if vk not in variant_order:
                variant_order.append(vk)
                variants.append(make_lb(case.lb, **_canon_lb_kwargs(case, cfg)))

        # pin the derived static sizes the padded tables would otherwise
        # perturb, so serial references share bit-identical shapes
        cph_b = 1
        padded_wls = {}
        for case in members:
            pwl = _pad_workload(case.workload, nc_b, cfg.n_hosts)
            padded_wls[case.name] = pwl
            counts = np.bincount(pwl.src, minlength=cfg.n_hosts)
            cph_b = max(cph_b, int(counts.max()))
        cfg_b = cfg.replace(msg_slots=msg_b, conns_per_host=cph_b, failure_slots=f_b)

        lb = SwitchLB(variants)
        first = members[0]
        sim = Simulator(
            cfg_b,
            padded_wls[first.name],
            lb,
            failures=self._live_failures(first).pad_to(f_b),
            watch_queues=_pad_watch(self._watch_for(first), bp.key[5]),
            seed=int(first.seeds[0]),
            device=self.device,
        )
        return _Program(
            group=gid, cfg=cfg_b, lb=lb, sim=sim, sim_ticks=ticks_b,
            masked=any(case.ticks < ticks_b for case in members),
            variant_order=variant_order, padded_wls=padded_wls,
        )

    def _build_bucket(self, bp: BucketPlan, by_name: dict[str, SweepCase]) -> _Bucket:
        f_b, w_b = bp.key[4], bp.key[5]
        prog = self.programs[bp.group]
        cfg = self.cfg
        dev = self.device

        cells: list[_Cell] = []
        for name in bp.cells:
            case = by_name[name]
            cells.append(_Cell(
                case=case,
                padded_wl=prog.padded_wls[name],
                padded_fs=self._live_failures(case).pad_to(f_b),
                padded_watch=_pad_watch(self._watch_for(case), w_b),
                branch=prog.variant_order.index(_variant_key(case, cfg)),
            ))

        # rows = cells × seeds, padded to the planned row count by
        # repeating row 0 (discarded on output)
        row_cells: list[tuple[_Cell, int]] = []
        for c in cells:
            for s in c.case.seeds:
                c.rows.append(len(row_cells))
                row_cells.append((c, int(s)))
        n_rows = len(row_cells)
        if n_rows != bp.n_rows:
            raise AssertionError((n_rows, bp))
        row_cells += [row_cells[0]] * (bp.n_padded_rows - n_rows)

        cph_b = prog.cfg.conns_per_host

        def stack(field_of):
            return torch.as_tensor(
                np.stack([np.asarray(field_of(c), np.int32) for c, _ in row_cells]), device=dev)

        scn = ScenarioArrays(
            conn_src=stack(lambda c: c.padded_wl.src),
            conn_dst=stack(lambda c: c.padded_wl.dst),
            conn_msg=stack(lambda c: c.padded_wl.msg_pkts),
            conn_start=stack(lambda c: c.padded_wl.start),
            conn_dep=stack(lambda c: c.padded_wl.dep),
            host_conns=stack(lambda c: _host_conns(c.padded_wl, cfg.n_hosts, cph_b)),
            watch=stack(lambda c: c.padded_watch),
            f_queue=stack(lambda c: c.padded_fs.queue),
            f_start=stack(lambda c: c.padded_fs.start),
            f_end=stack(lambda c: c.padded_fs.end),
            f_kind=stack(lambda c: c.padded_fs.kind),
            f_param=stack(lambda c: c.padded_fs.param),
        )
        keys = torch.stack([rng.PRNGKey(s, device=dev) for _, s in row_cells])
        branch_idx = np.asarray([c.branch for c, _ in row_cells], np.int32)
        horizons = np.asarray([c.case.ticks for c, _ in row_cells], np.int32)
        return _Bucket(
            plan=bp, program=prog, cells=cells, n_rows=n_rows,
            keys=keys, scn=scn, branch_idx=branch_idx, horizons=horizons,
            horizons_t=torch.as_tensor(horizons, device=dev),
        )

    # ------------------------------------------------------------------
    def serial_sim(self, name: str, seed: int | None = None) -> Simulator:
        """The serial reference for a cell: a plain Simulator built on the
        same padded scenario and shape-pinned config the sweep row ran, on
        the engine's device — ``serial_sim(name).run(case.ticks)`` is
        bit-identical to the sweep row (which froze at exactly that horizon
        in a merged bucket)."""
        for b in self.buckets:
            for c in b.cells:
                if c.case.name == name:
                    lb = make_lb(c.case.lb, **_canon_lb_kwargs(c.case, self.cfg))
                    return Simulator(
                        b.cfg, c.padded_wl, lb, failures=c.padded_fs,
                        watch_queues=c.padded_watch,
                        seed=int(c.case.seeds[0] if seed is None else seed),
                        device=self.device,
                    )
        raise KeyError(name)

    # ------------------------------------------------------------------
    def _init_states(self, bucket: _Bucket) -> SimState:
        """Per-row initial states (each load balancer's from its row's
        ``fold_in(key, 777)``), stacked, with each row's SwitchLB branch."""
        rows = [bucket.sim.init_state(k) for k in bucket.keys]
        states = tree_map(lambda *leaves: torch.stack(leaves), *rows)
        return states.replace(lb_state=bucket.lb.with_branch(states.lb_state, bucket.branch_idx))

    def _spec(self, collect: str, spec: TelemetrySpec | None) -> TelemetrySpec | None:
        if collect not in ("none", "summary", "full"):
            raise ValueError(f"collect must be 'none', 'summary' or 'full', got {collect!r}")
        return (spec or TelemetrySpec.default()) if collect == "summary" else None

    def _tel_prog(self, prog: _Program, spec: TelemetrySpec):
        """The program's TelemetryProgram for a spec (built once; shapes and
        window strides derive from the group's bucket horizon)."""
        if spec not in prog.tel_progs:
            prog.tel_progs[spec] = spec.build(prog.sim, prog.sim_ticks)
        return prog.tel_progs[spec]

    def _trc_prog(self, prog: _Program, trace: TraceSpec):
        """The program's TracerProgram for a TraceSpec (built once)."""
        if trace not in prog.trc_progs:
            prog.trc_progs[trace] = trace.build(prog.sim, prog.sim_ticks)
        return prog.trc_progs[trace]

    def _make_chunk_fn(self, prog: _Program, n: int, collect: str, spec,
                       trace: TraceSpec | None = None):
        """The runner of one chunk of ``n`` ticks: ``(carry, keys, scn,
        horizons, t0) -> (carry, traces or None)``, shared by every bucket of
        the program's split group.  Rows whose horizon falls before the
        chunk's end are frozen there (see the module docstring, item 4);
        the telemetry carry and, when tracing, the flight-ring carry are
        updated in place and frozen with them."""
        sim = prog.sim
        full = collect == "full"
        summary = collect == "summary"
        tel_prog = self._tel_prog(prog, spec) if summary else None
        trc_prog = self._trc_prog(prog, trace) if trace is not None else None
        dev = sim.device
        row_sets: dict = {}  # (horizons, from, to) -> (row ids, row mask) on the device

        def rows_frozen_at(hz: np.ndarray, lo: int, hi: int):
            key = (hz.tobytes(), lo, hi)
            if key not in row_sets:
                sel = (hz > lo) & (hz <= hi)
                row_sets[key] = (torch.as_tensor(np.nonzero(sel)[0], device=dev),
                                 torch.as_tensor(sel, device=dev))
            return row_sets[key]

        def fn(carry, keys, scn, horizons, t0):
            t0 = int(t0)
            end = t0 + n
            states, tel, trc = (carry + (None,))[:3] if summary else (carry, None, None)
            hz = np.asarray(horizons, np.int64)
            if not full and hz.max() <= t0:
                return carry, None  # every row is past its horizon: nothing to run
            # rows frozen by the chunk's end, by the tick their state is kept
            # at: t0 for rows frozen before the chunk, else their horizon
            keep_at = sorted({t0} | {int(h) for h in hz if t0 < h < end}) if hz.min() < end else []
            sets = {s: rows_frozen_at(hz, -1 if s == t0 else s - 1, s) for s in keep_at}
            kept = {}

            def keep(s):
                idx, mask = sets[s]
                if idx.numel():
                    kept[s] = (states, tel.index_select(0, idx) if summary else None,
                               trc.index_select(0, idx) if trc is not None else None, idx, mask)

            if t0 in sets:
                keep(t0)
            trs = []
            chunk = sim.draw_chunk(keys.shape[0])
            for c0 in range(t0, end, chunk):
                m = min(chunk, end - c0)
                draws = sim.tick_draws(keys, c0, m, scn)
                for i in range(m):
                    t = c0 + i
                    if trc is not None:
                        states, probe, events = sim.step_events_rows(states, t, draws.row(i), scn)
                        tel_prog.update(tel, probe)
                        trc_prog.update(trc, probe, events)
                    elif summary:
                        states, probe = sim.step_probe_rows(states, t, draws.row(i), scn)
                        tel_prog.update(tel, probe)
                    elif full:
                        states, tr = sim.step_rows(states, t, draws.row(i), scn)
                        trs.append(tr)
                    else:
                        states, _ = sim.step_rows(states, t, draws.row(i), scn, trace=False)
                    if t + 1 in sets and t + 1 < end:
                        keep(t + 1)
            for old, tel_rows, trc_rows, idx, mask in kept.values():  # copy the frozen rows back
                states = tree_map(lambda new, o, m=mask: _rows_from(m, o, new), states, old)
                if summary:
                    tel.index_copy_(0, idx, tel_rows)
                if trc is not None:
                    trc.index_copy_(0, idx, trc_rows)
            traces = TickTrace(*(torch.stack(f) for f in zip(*trs))) if full else None
            if not summary:
                return states, traces
            return ((states, tel) if trc is None else (states, tel, trc)), traces

        return fn

    def _quiescent(self, prog: _Program):
        """Per-row fixed-point detector.  A row is quiescent when no packet
        slot is allocated (every live packet state holds a slot until
        consumed) and no connection that can still start within the row's
        horizon has work left — or when the row is already past its horizon
        (frozen).  Once all rows hold, every later tick is a no-op for
        packet/conn/stat state, so the remaining chunks can be skipped
        without changing any reported result (only time-keeping LB
        internals, e.g. PLB epoch clocks, would have kept advancing).  One
        device-to-host read per call."""
        NP = prog.sim.NP

        def f(states: SimState, scn: ScenarioArrays, horizon: torch.Tensor, offset: int) -> bool:
            no_pkts = states.fl_count == NP  # (R,)
            dep = scn.conn_dep.clamp(0, scn.conn_src.shape[-1] - 1).long()
            dep_ok = (scn.conn_dep < 0) | torch.gather(states.c_done, 1, dep)
            startable = (scn.conn_start < horizon[:, None]) & dep_ok
            has_work = (states.c_rtx_count > 0) | (states.c_next_new < scn.conn_msg)
            active = startable & ~states.c_done & has_work
            quiet = no_pkts & ~active.any(dim=-1)
            return bool((quiet | (horizon <= offset)).all())

        return f

    def run(
        self,
        collect: str = "none",
        chunk: int | None = None,
        early_exit: bool = False,
        telemetry: TelemetrySpec | None = None,
        trace: TraceSpec | None = None,
    ) -> SweepResult:
        """Execute every bucket.  The three-mode ``collect`` contract:

        * ``"none"``    — no per-tick output (fastest; state summaries
          only).  Early-exit compatible.
        * ``"summary"`` — on-device sketch channels (``telemetry`` spec,
          default ``TelemetrySpec.default()``) folded into every tick;
          O(bins) host bytes per row.  Early-exit compatible: reducers are
          no-ops on quiescent ticks, so skipping them is bit-invisible.
        * ``"full"``    — raw TickTrace streams copied to the host chunk by
          chunk; O(ticks) host bytes per row.  Incompatible with
          ``early_exit``.

        ``chunk`` bounds how many ticks of trace live on the device at once
        (defaults to the whole run in one chunk, or ``max(64, ticks // 8)``
        with ``early_exit``).  ``early_exit`` stops a bucket at the first
        chunk boundary where every row has reached its fixed point; all
        reported metrics are bit-identical to running the full horizon.

        ``trace`` (a ``tracer.TraceSpec``, summary mode only) also carries
        the flight-recorder ring per row; decoded events come back via
        ``SweepResult.flight_for``.  Tracing is observation-only: every
        state and telemetry array is bit-identical with it on or off.
        """
        if collect not in ("none", "summary", "full"):
            raise ValueError(f"collect must be 'none', 'summary' or 'full', got {collect!r}")
        _check_trace(collect, trace)
        if early_exit and collect == "full":
            raise ValueError(
                "early_exit=True cannot be combined with collect='full': "
                "raw trace streams would be truncated at the quiescence "
                "point.  Use collect='summary' (on-device sketch channels "
                "keep figure fidelity and are early-exit safe) or "
                "collect='none', or run the full horizon with "
                "early_exit=False."
            )
        if telemetry is not None and collect != "summary":
            raise ValueError("a telemetry spec only applies to collect='summary'")
        spec = self._spec(collect, telemetry)
        for bucket in self.buckets:
            self._run_bucket(bucket, collect, chunk, early_exit, spec, trace)
        return SweepResult(self)

    # ------------------------------------------------------------------
    # Chunked carry in/out — the resumable building blocks ``run`` drives: a
    # bucket's execution is ``carry = bucket_carry(...)`` followed by any
    # sequence of ``run_chunk`` calls whose (t0, n) windows tile ``[0,
    # ticks)``, and the result is bit-identical however the windows are
    # cut, which is what lets a saved carry resume at any chunk boundary.
    # ------------------------------------------------------------------
    def bucket_carry(self, bucket: _Bucket, collect: str = "none",
                     spec: TelemetrySpec | None = None, trace: TraceSpec | None = None):
        """The bucket's t=0 carry: per-row init states (leaves ``(R, ...)``),
        plus, in summary mode, the ``(R, size)`` int32 telemetry carry, plus,
        when tracing, the ``(R, size)`` int32 flight-ring carry."""
        _check_trace(collect, trace)
        spec = self._spec(collect, spec)
        carry = self._init_states(bucket)
        if collect == "summary":
            rows = bucket.plan.n_padded_rows
            tel0 = self._tel_prog(bucket.program, spec).init_rows(rows)
            carry = (carry, tel0)
            if trace is not None:
                carry += (self._trc_prog(bucket.program, trace).init_rows(rows),)
        return carry

    def chunk_runner(self, bucket: _Bucket, n: int, collect: str = "none",
                     spec: TelemetrySpec | None = None, trace: TraceSpec | None = None):
        """The ``(carry, keys, scn, horizons, t0) -> (carry, traces)`` runner
        of an ``n``-tick chunk: a plain callable (nothing is compiled, so the
        reference's ``example_carry`` has no counterpart), made once per
        ``(n, collect, spec, trace)`` and shared by every sub-bucket of the
        program's split group."""
        _check_trace(collect, trace)
        spec = self._spec(collect, spec)
        prog = bucket.program
        ck = (int(n), collect, spec, trace)
        if ck not in prog.chunk_fns:
            prog.chunk_fns[ck] = self._make_chunk_fn(prog, int(n), collect, spec, trace)
        return prog.chunk_fns[ck]

    def run_chunk(self, bucket: _Bucket, carry, t0: int, n: int, collect: str = "none",
                  spec: TelemetrySpec | None = None, trace: TraceSpec | None = None):
        """Advance one bucket's carry over ticks ``[t0, t0 + n)``.  Returns
        ``(carry, traces)``.  The states passed in are left unchanged; the
        telemetry carry (summary mode) and the flight-ring carry (tracing)
        are updated in place and returned, so copy them to the host
        *before* the call to keep them.  Rows whose own
        horizon lies inside the window freeze bit-exactly there, so driving
        a bucket to its horizon in any chunking yields identical results.
        The draws are made ``sim.draw_chunk(rows)`` ticks at a time."""
        fn = self.chunk_runner(bucket, n, collect, spec, trace=trace)
        return fn(carry, bucket.keys, bucket.scn, bucket.horizons, t0)

    def finalize_bucket(self, bucket: _Bucket, carry, collect: str, ticks_run: int,
                        trace_chunks=None, spec: TelemetrySpec | None = None,
                        trace: TraceSpec | None = None):
        """Publish a finished carry onto the bucket (one host copy per
        leaf): ``final_state`` / ``telemetry`` / ``traces`` / ``trace_rows``
        as ``SweepResult`` expects, pad rows dropped."""
        _check_trace(collect, trace)
        summary = collect == "summary"
        keep = bucket.n_rows
        states = carry[0] if summary else carry
        bucket.final_state = tree_map(lambda x: x[:keep].cpu(), states)
        bucket.ticks_run = ticks_run
        if summary:
            bucket.telemetry = carry[1][:keep].cpu().numpy().copy()
            bucket.tel_prog = self._tel_prog(bucket.program, self._spec(collect, spec))
            if trace is not None:
                bucket.trace_rows = carry[2][:keep].cpu().numpy().copy()
                bucket.trc_prog = self._trc_prog(bucket.program, trace)
        if collect == "full" and trace_chunks:
            bucket.traces = TickTrace(*(torch.cat(f)[:, :keep] for f in zip(*trace_chunks)))

    def _run_bucket(self, bucket: _Bucket, collect: str, chunk: int | None,
                    early_exit: bool = False, spec: TelemetrySpec | None = None,
                    trace: TraceSpec | None = None):
        ticks = bucket.ticks
        summary = collect == "summary"
        if chunk is None:
            # early exit needs chunk boundaries to act on
            chunk = max(64, ticks // 8) if early_exit else ticks
        chunk = max(1, min(chunk, ticks))
        sizes = [chunk] * (ticks // chunk)
        if ticks % chunk:
            sizes.append(ticks % chunk)

        t_c0 = time.perf_counter()
        carry = self.bucket_carry(bucket, collect, spec, trace)
        quiescent = self._quiescent(bucket.program) if early_exit else None
        _sync(self.device)
        bucket.compile_wall_s = time.perf_counter() - t_c0

        trace_chunks = []
        offset = 0
        t_e0 = time.perf_counter()
        for n in sizes:
            carry, traces = self.run_chunk(bucket, carry, offset, n, collect, spec, trace)
            offset += n
            if collect == "full":
                # to the host chunk by chunk: the device never holds more
                # than `chunk` ticks of trace
                trace_chunks.append(TickTrace(*(f.cpu() for f in traces)))
            states = carry[0] if summary else carry
            if quiescent is not None and offset < ticks and quiescent(
                    states, bucket.scn, bucket.horizons_t, offset):
                break
        _sync(self.device)
        bucket.exec_wall_s = time.perf_counter() - t_e0
        self.finalize_bucket(bucket, carry, collect, offset, trace_chunks, spec, trace)


def _check_trace(collect: str, trace) -> None:
    if trace is not None and collect != "summary":
        raise ValueError(
            "trace=TraceSpec(...) requires collect='summary' (the "
            "flight recorder rides the telemetry carry contract)"
        )


def _rows_from(mask: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``old`` on the rows where ``mask (R,)`` holds, ``new`` elsewhere (a
    leaf shared by both is left as it is)."""
    if new is old:
        return new
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), old, new)
