# Frozen copy of the port's plain formulation (src/repro_torch/netsim/telemetry.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""On-device telemetry: streaming sketch channels for summary collection
(counterpart of ``repro.netsim.telemetry``).

Instead of a per-tick trace, each channel is a reducer folded into the tick
loop: its carry stays on the device and leaves it once, as O(bins)
integers per row.  The channels, the spec grammar, the slot layout of the
carry and every finalized number are the reference's, bit for bit:

* ``CounterTotals``   — running sums of the per-tick stat deltas; they equal
  the final ``SimState.s_stats``.
* ``RunningScalars``  — exact count / sum / min / max of FCTs, the last
  completion tick, queue-occupancy max and sum.
* ``Histogram``       — fixed-width log- (or linear-) spaced histogram of FCT
  or queue-length observations (percentiles to bin resolution,
  ``sketch_percentile``); zero qlen observations are reconstructed at
  ``finalize`` from the horizon.
* ``WindowedSeries``  — per-window sums at a stride: watched links' service
  counts and occupancy, and the stat-delta vector.
* ``RecoveryTracker`` — the first failure drop, and the first timeout and
  first delivery after it.

How the port computes them, on B rows at once (``Simulator.probe`` gives
each tick's ``Probe`` with a leading row axis; ``now`` is a host int):

* The carry is one ``(B, size)`` int32 tensor; each channel's fields are
  views of it, and the built-in channels update those views in place, so
  no tick rebuilds the carry.
* A histogram bins with ``torch.searchsorted`` over its inner edges (the
  reference's ``searchsorted(edges, v, side="right") - 1`` clipped to
  ``[0, n_bins)``) and counts with one ``seg_sum`` launch for all rows: the
  hand-written kernel on the card, its plain version on the CPU.  The
  reference's dense ``(K, n_bins)`` one-hot is never built.
* A window's index is a host int (``now`` is one), so a windowed update is
  an add into one row of the carry.
* Nothing reads a device value on the host inside the tick.

User-defined channels keep the reference's protocol (``key``, ``build``,
``slots``, ``init``, ``update``, ``finalize``) over torch tensors:
``update(built, v, probe)`` gets its fields as ``(B, *shape)`` views of the
carry and returns their new values, which the program copies into the carry
(a view updated in place and returned as it is costs no copy).

Example::

    spec = TelemetrySpec.default(n_windows=32)
    states, tel = FleetRunner(cfg, wl, lb, seeds=range(8)).run_summary(4000, spec)
    tel.result(0)["fct_hist"]           # counts + edges, seed 0
    tel.summaries()[0].p99_fct_ticks    # sketch p99 (bin resolution)
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from . import ops as kernel_ops
from .config import TICK_NS
from .engine import (
    BIG, N_STATS, ST_DELIVERED, ST_DROPS_CONG, ST_DROPS_FAIL, ST_ECN, ST_INJECTED, ST_TIMEOUTS,
    Probe,
)

STAT_NAMES = (
    "drops_cong", "drops_fail", "timeouts", "delivered",
    "ecn_marks", "injected", "unprocessed", "alloc_fails",
)

# RecoveryTracker reads these three stats as one slice
assert (ST_TIMEOUTS, ST_DELIVERED) == (ST_DROPS_FAIL + 1, ST_DROPS_FAIL + 2)

# the channels metrics.summarize_sketch needs to build a RunSummary
SUMMARY_CHANNEL_KEYS = frozenset({"counters", "scalars", "fct_hist"})

I32 = torch.int32

# Run-long sums (FCT, queue occupancy, qlen bin counts) can pass 2^31, so a
# wide sum is split into (hi, lo) words: lo holds the low SUM_SHIFT bits, hi
# counts 2^SUM_SHIFT units (exact up to ~2^51).  Each tick's increment stays
# below 2^31 - 2^SUM_SHIFT, so nothing wraps; the carry is normalized every
# tick, as the reference's.
SUM_SHIFT = 20
_LO_MASK = (1 << SUM_SHIFT) - 1


def _acc_wide(hi: torch.Tensor, lo: torch.Tensor, delta: torch.Tensor) -> None:
    """The reference's ``(hi, lo) + delta``, in place on carry views."""
    lo.add_(delta)
    hi.add_(lo >> SUM_SHIFT)
    lo.bitwise_and_(_LO_MASK)


def _wide_total(hi, lo) -> int:
    return (int(hi) << SUM_SHIFT) + int(lo)


@functools.lru_cache(maxsize=None)
def _const(value: int, device: torch.device) -> torch.Tensor:
    """A 0-dim int32 constant on ``device``, made once.  As a ``torch.where``
    operand it costs no launch (on a CUDA device a Python scalar there is
    written into a tensor by a fill kernel first)."""
    return torch.tensor(value, dtype=I32, device=device)


def _conn_mask(conn_filter, n_conns: int) -> np.ndarray:
    """A cohort's static conn-id tuple as a (NC,) bool mask; out-of-range ids
    are rejected here rather than silently dropped."""
    mask = np.zeros((n_conns,), bool)
    ids = np.asarray(conn_filter, np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= n_conns):
        raise ValueError(
            f"conn_filter ids must be in [0, {n_conns}), got [{ids.min()}, {ids.max()}]"
        )
    mask[ids] = True
    return mask


# ---------------------------------------------------------------------------
# Channels.  Each is a frozen (hashable) dataclass of declarative knobs; the
# static per-program context (shapes, bin edges, strides, device constants)
# is made by ``build(sim, ticks)`` and handed back to the other methods.
#   slots(built)            -> {field: shape}          (all int32)
#   init(built)             -> {field: np.ndarray}
#   update(built, v, probe) -> {field: tensor}         (v: (B, *shape) views)
#   finalize(built, v, horizon) -> {metric: value}     (host-side numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CounterTotals:
    """Running sums of ``probe.stats_delta``: equals the final ``s_stats``."""

    @property
    def key(self) -> str:
        return "counters"

    def build(self, sim, ticks: int) -> dict:
        return {}

    def slots(self, built) -> dict:
        return {"totals": (N_STATS,)}

    def init(self, built) -> dict:
        return {"totals": np.zeros((N_STATS,), np.int32)}

    def update(self, built, v: dict, probe: Probe) -> dict:
        v["totals"].add_(probe.stats_delta)
        return v

    def finalize(self, built, v: dict, horizon: int) -> dict:
        totals = np.asarray(v["totals"])
        out = {name: int(totals[i]) for i, name in enumerate(STAT_NAMES)}
        out["totals"] = totals
        return out


@dataclasses.dataclass(frozen=True)
class RunningScalars:
    """Exact running scalars: FCT count / sum / min / max, the last
    completion tick, queue-occupancy max and sum (the two run-long sums
    split into (hi, lo) words).  ``conn_filter`` restricts the FCT side to a
    cohort of conn ids, under a distinct ``name``."""

    conn_filter: tuple[int, ...] | None = None
    name: str | None = None

    @property
    def key(self) -> str:
        return self.name or "scalars"

    def build(self, sim, ticks: int) -> dict:
        built = {"nq": sim.NQ, "device": sim.device}
        if self.conn_filter is not None:
            built["mask"] = _conn_mask(self.conn_filter, sim.wl.n_conns)
            built["mask_t"] = torch.as_tensor(built["mask"], device=sim.device)
        return built

    def slots(self, built) -> dict:
        return {
            "fct_count": (), "fct_sum_hi": (), "fct_sum_lo": (),
            "fct_min": (), "fct_max": (), "done_tick_max": (),
            "qlen_max": (), "qlen_sum_hi": (), "qlen_sum_lo": (),
        }

    def init(self, built) -> dict:
        z = np.zeros((), np.int32)
        return {
            "fct_count": z, "fct_sum_hi": z, "fct_sum_lo": z,
            "fct_min": np.asarray(BIG, np.int32),
            "fct_max": np.asarray(-1, np.int32),
            "done_tick_max": np.asarray(-1, np.int32),
            "qlen_max": z, "qlen_sum_hi": z, "qlen_sum_lo": z,
        }

    def update(self, built, v: dict, probe: Probe) -> dict:
        d, fct = probe.done_now, probe.fct  # fct is 0 where ~d
        dev = built["device"]
        if "mask_t" in built:
            d = d & built["mask_t"]
            fct = torch.where(built["mask_t"], fct, _const(0, dev))
        count = d.sum(dim=-1, dtype=I32)
        v["fct_count"].add_(count)
        _acc_wide(v["fct_sum_hi"], v["fct_sum_lo"], fct.sum(dim=-1, dtype=I32))
        fct_min = torch.where(d, fct, _const(BIG, dev)).amin(dim=-1)
        torch.minimum(v["fct_min"], fct_min, out=v["fct_min"])
        fct_max = torch.where(d, fct, _const(-1, dev)).amax(dim=-1)
        torch.maximum(v["fct_max"], fct_max, out=v["fct_max"])
        # max(last, now if a conn completed else -1); last >= -1 always
        last = v["done_tick_max"]
        torch.where(count > 0, last.clamp(min=probe.now), last, out=last)
        torch.maximum(v["qlen_max"], probe.q_len.amax(dim=-1), out=v["qlen_max"])
        _acc_wide(v["qlen_sum_hi"], v["qlen_sum_lo"], probe.q_len.sum(dim=-1, dtype=I32))
        return v

    def finalize(self, built, v: dict, horizon: int) -> dict:
        count = int(v["fct_count"])
        fct_sum = _wide_total(v["fct_sum_hi"], v["fct_sum_lo"])
        qlen_sum = _wide_total(v["qlen_sum_hi"], v["qlen_sum_lo"])
        return {
            "fct_count": count,
            "fct_sum": fct_sum,
            "fct_min": int(v["fct_min"]) if count else -1,
            "fct_max": int(v["fct_max"]),
            "mean_fct_ticks": float(fct_sum) / count if count else float("nan"),
            "done_tick_max": int(v["done_tick_max"]),
            "qlen_max": int(v["qlen_max"]),
            "mean_qlen": float(qlen_sum) / (horizon * built["nq"]),
        }


@dataclasses.dataclass(frozen=True)
class Histogram:
    """Fixed-width histogram of an on-device value stream: ``source="fct"``
    bins completion times as they happen, ``source="qlen"`` every queue's
    nonzero occupancy every tick (the zeros are reconstructed at
    ``finalize`` as ``horizon × NQ - sum(counts)``).  ``hi=None`` takes the
    top edge from the program (the horizon for FCT, the queue capacity for
    qlen).  ``conn_filter`` (FCT only) restricts it to a cohort of conn ids,
    under a distinct ``name``.  Counts are (hi, lo) split words."""

    source: str = "fct"  # "fct" | "qlen"
    n_bins: int = 64
    lo: int = 1
    hi: int | None = None
    spacing: str = "log"  # "log" | "linear"
    name: str | None = None
    conn_filter: tuple[int, ...] | None = None

    @property
    def key(self) -> str:
        return self.name or f"{self.source}_hist"

    def build(self, sim, ticks: int) -> dict:
        assert self.source in ("fct", "qlen"), self.source
        assert self.spacing in ("log", "linear"), self.spacing
        if self.conn_filter is not None and self.source != "fct":
            raise ValueError("conn_filter only applies to source='fct' histograms")
        hi = self.hi
        if hi is None:
            hi = ticks if self.source == "fct" else sim.cfg.queue_capacity
        hi = max(int(hi), self.lo + 1)
        # the reference's edges: numpy in float64, then float32
        if self.spacing == "log":
            edges = np.geomspace(float(self.lo), float(hi), self.n_bins + 1)
        else:
            edges = np.linspace(float(self.lo), float(hi), self.n_bins + 1)
        built = {
            "edges": edges.astype(np.float32),
            # streams observed per tick (zero-count reconstruction); 0 for
            # event-driven sources
            "n_streams": sim.NQ if self.source == "qlen" else 0,
        }
        # searchsorted(edges, v, right) - 1 clipped to [0, n_bins) counts the
        # inner edges e_1 .. e_{n-1} at or below v: no subtract, no clip
        built["inner"] = torch.as_tensor(built["edges"][1:-1], device=sim.device)
        if self.conn_filter is not None:
            built["mask"] = _conn_mask(self.conn_filter, sim.wl.n_conns)
            built["mask_t"] = torch.as_tensor(built["mask"], device=sim.device)
        return built

    def slots(self, built) -> dict:
        return {"counts_hi": (self.n_bins,), "counts_lo": (self.n_bins,)}

    def init(self, built) -> dict:
        return {
            "counts_hi": np.zeros((self.n_bins,), np.int32),
            "counts_lo": np.zeros((self.n_bins,), np.int32),
        }

    def update(self, built, v: dict, probe: Probe) -> dict:
        if self.source == "fct":
            vals, mask = probe.fct, probe.done_now
            if "mask_t" in built:
                mask = mask & built["mask_t"]
        else:
            vals, mask = probe.q_len, probe.q_len > 0
        idx = torch.searchsorted(built["inner"], vals.float(), right=True, out_int32=True)
        # a segment count is the one-hot sum: the mask is the counted field,
        # so a masked lane adds 0 to its bin
        binned = kernel_ops.seg_sum(idx, (mask,), self.n_bins)[..., 0, :]
        _acc_wide(v["counts_hi"], v["counts_lo"], binned)
        return v

    def finalize(self, built, v: dict, horizon: int) -> dict:
        counts = (np.asarray(v["counts_hi"], np.int64) << SUM_SHIFT) + np.asarray(
            v["counts_lo"], np.int64)
        zeros = 0
        if built["n_streams"]:
            zeros = int(horizon) * built["n_streams"] - int(counts.sum())
        return {
            "counts": counts,
            "edges": np.asarray(built["edges"], np.float64),
            "zeros": zeros,
        }


@dataclasses.dataclass(frozen=True)
class WindowedSeries:
    """Windowed time series at a stride: per-watched-link service counts
    (utilization), watched queue occupancy sums, and the stat-delta vector
    per window.  ``stride=None`` takes ``ceil(ticks / n_windows)`` from the
    program's horizon."""

    stride: int | None = None
    n_windows: int = 24

    @property
    def key(self) -> str:
        return "windows"

    def build(self, sim, ticks: int) -> dict:
        stride = self.stride or max(1, -(-ticks // self.n_windows))
        return {
            "stride": int(stride),
            "nw": -(-ticks // int(stride)),
            "w": int(sim.watch.shape[0]),
        }

    def slots(self, built) -> dict:
        nw, w = built["nw"], built["w"]
        return {"util": (nw, w), "qlen_sum": (nw, w), "stats": (nw, N_STATS)}

    def init(self, built) -> dict:
        return {k: np.zeros(s, np.int32) for k, s in self.slots(built).items()}

    def update(self, built, v: dict, probe: Probe) -> dict:
        w = min(probe.now // built["stride"], built["nw"] - 1)  # a host int
        v["util"][:, w].add_(probe.watch_served)
        v["qlen_sum"][:, w].add_(probe.watch_qlen)
        v["stats"][:, w].add_(probe.stats_delta)
        return v

    def finalize(self, built, v: dict, horizon: int) -> dict:
        stride = built["stride"]
        nw = min(built["nw"], -(-int(horizon) // stride))
        ticks_per = np.minimum(stride, int(horizon) - stride * np.arange(nw)).astype(np.float64)
        util = np.asarray(v["util"])[:nw]
        stats = np.asarray(v["stats"])[:nw]
        return {
            "stride": stride,
            "ticks_per_window": ticks_per,
            "util": util,
            "util_frac": util / ticks_per[:, None],
            "mean_qlen": np.asarray(v["qlen_sum"])[:nw] / ticks_per[:, None],
            "stats": stats,
            "ecn": stats[:, ST_ECN],
            "drops": stats[:, ST_DROPS_CONG] + stats[:, ST_DROPS_FAIL],
            "delivered": stats[:, ST_DELIVERED],
            "injected": stats[:, ST_INJECTED],
        }


@dataclasses.dataclass(frozen=True)
class RecoveryTracker:
    """Failure-recovery latency: the first failure-drop tick, the first
    sender timeout after it and the first delivery after it;
    ``recovery_ticks`` is first drop -> first delivery.  Deliveries in the
    tick of the first drop do not count."""

    @property
    def key(self) -> str:
        return "recovery"

    def build(self, sim, ticks: int) -> dict:
        return {}

    def slots(self, built) -> dict:
        return {"first_drop": (), "first_timeout": (), "first_redeliver": ()}

    def init(self, built) -> dict:
        b = np.asarray(BIG, np.int32)
        return {"first_drop": b, "first_timeout": b, "first_redeliver": b}

    def update(self, built, v: dict, probe: Probe) -> dict:
        now = probe.now
        seen = probe.stats_delta[:, ST_DROPS_FAIL:ST_DELIVERED + 1] > 0  # drop, timeout, delivery

        def first(x, hit):  # min(x, now if hit else BIG), in place
            torch.where(hit, x.clamp(max=now), x, out=x)

        first(v["first_drop"], seen[:, 0])
        after = now > v["first_drop"]  # against this tick's updated first drop
        hit = seen[:, 1:] & after[:, None]
        first(v["first_timeout"], hit[:, 0])
        first(v["first_redeliver"], hit[:, 1])
        return v

    def finalize(self, built, v: dict, horizon: int) -> dict:
        def t(x):
            x = int(x)
            return -1 if x >= BIG else x

        drop, timeout, rer = t(v["first_drop"]), t(v["first_timeout"]), t(v["first_redeliver"])
        rec = rer - drop if (drop >= 0 and rer >= 0) else -1
        return {
            "first_drop_tick": drop,
            "first_timeout_tick": timeout,
            "first_redeliver_tick": rer,
            "recovery_ticks": rec,
            "recovery_us": rec * TICK_NS / 1000.0 if rec >= 0 else float("nan"),
        }


# ---------------------------------------------------------------------------
# Spec + compiled program.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """A declarative, hashable channel set: a tuple of channels
    (``CounterTotals``, ``RunningScalars``, ``Histogram``,
    ``WindowedSeries``, ``RecoveryTracker``, or user-defined objects with
    the same protocol) whose ``key``s are unique.  ``build(sim, ticks)``
    lays it out against one simulator and horizon as a ``TelemetryProgram``.
    Every channel's update is a no-op on an all-zero (quiescent) probe.
    ``default()`` rebuilds a ``RunSummary`` (``SUMMARY_CHANNEL_KEYS``)."""

    channels: tuple = ()

    @staticmethod
    def default(
        fct_bins: int = 64,
        qlen_bins: int = 32,
        n_windows: int = 24,
        stride: int | None = None,
    ) -> "TelemetrySpec":
        return TelemetrySpec(
            channels=(
                CounterTotals(),
                RunningScalars(),
                Histogram(source="fct", n_bins=fct_bins),
                Histogram(source="qlen", n_bins=qlen_bins),
                WindowedSeries(stride=stride, n_windows=n_windows),
                RecoveryTracker(),
            )
        )

    def build(self, sim, ticks: int) -> "TelemetryProgram":
        return TelemetryProgram(self, sim, ticks)

    def with_cohorts(self, cohorts: dict, fct_bins: int = 64) -> "TelemetrySpec":
        """This spec plus one FCT histogram and scalar pair per cohort
        (``{label: conn ids}``), as ``fct_hist_<label>`` / ``scalars_<label>``."""
        extra = []
        for label, ids in cohorts.items():
            ids = tuple(int(i) for i in ids)
            extra.append(Histogram(source="fct", n_bins=fct_bins, name=f"fct_hist_{label}",
                                   conn_filter=ids))
            extra.append(RunningScalars(name=f"scalars_{label}", conn_filter=ids))
        return TelemetrySpec(channels=self.channels + tuple(extra))


class TelemetryProgram:
    """A spec laid out against one simulator: every channel's fields packed
    into ONE flat ``(size,)`` int32 vector per row, in the reference's slot
    order.  ``update`` folds a tick's ``Probe`` of B rows into a ``(B,
    size)`` carry on the simulator's device; ``finalize_row`` unpacks a
    host-side row."""

    def __init__(self, spec: TelemetrySpec, sim, ticks: int):
        self.spec = spec
        self.ticks = int(ticks)
        self.device = sim.device
        if not spec.channels:
            raise ValueError("empty TelemetrySpec: add channels, or start from "
                             "TelemetrySpec.default()")
        keys = [ch.key for ch in spec.channels]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate telemetry channel keys: {keys}")
        self._built = [(ch, ch.build(sim, ticks)) for ch in spec.channels]
        self._layout: list[tuple[Any, Any, str, int, tuple, int]] = []
        off = 0
        for ch, built in self._built:
            for field, shape in ch.slots(built).items():
                size = int(np.prod(shape, dtype=np.int64)) if shape else 1
                self._layout.append((ch, built, field, off, tuple(shape), size))
                off += size
        self.size = off
        self._carry_views: tuple | None = None  # (carry, its views): made once per carry

    @property
    def nbytes(self) -> int:
        """Host-transfer bytes per row."""
        return self.size * 4

    @property
    def channel_keys(self) -> frozenset:
        return frozenset(ch.key for ch, _ in self._built)

    def init(self) -> torch.Tensor:
        """One row's initial carry, ``(size,)`` int32 on the device."""
        flat = np.zeros((self.size,), np.int32)
        for ch, built, field, off, shape, size in self._layout:
            flat[off: off + size] = np.asarray(ch.init(built)[field], np.int32).reshape(-1)
        return torch.as_tensor(flat, device=self.device)

    def init_rows(self, n_rows: int) -> torch.Tensor:
        """``n_rows`` initial carries, ``(n_rows, size)``."""
        return self.init()[None].repeat(n_rows, 1)

    def _views(self, flat) -> dict:
        """Each channel's fields as views of ``flat`` (``(size,)`` or with a
        leading row axis)."""
        lead = tuple(flat.shape[:-1])
        views: dict[int, dict] = {}
        for ch, built, field, off, shape, size in self._layout:
            part = flat[..., off: off + size]
            views.setdefault(id(ch), {})[field] = (part.view if isinstance(part, torch.Tensor)
                                                   else part.reshape)((*lead, *shape))
        return views

    def update(self, flat: torch.Tensor, probe: Probe) -> torch.Tensor:
        """Fold one tick's ``Probe`` of B rows into the carry ``flat (B,
        size)``, in place (and return it).  ``probe.now`` is the tick."""
        cached = self._carry_views
        if cached is None or cached[0] is not flat:
            cached = self._carry_views = (flat, self._views(flat))
        views = cached[1]
        for ch, built in self._built:
            v = views[id(ch)]
            new = ch.update(built, v, probe)
            for field, t in new.items():
                if t is not v[field]:
                    v[field].copy_(t)
        return flat

    def finalize_row(self, flat: np.ndarray, horizon: int) -> dict:
        """Unpack one host-side row into ``{channel.key: {metric: value}}``;
        ``horizon`` (the row's own) drives zero-count reconstruction and
        window trimming."""
        flat = np.asarray(flat)
        assert flat.shape == (self.size,), (flat.shape, self.size)
        views = self._views(flat)
        return {ch.key: ch.finalize(built, views[id(ch)], int(horizon))
                for ch, built in self._built}

    def live_row(self, flat: np.ndarray, cursor: int) -> dict:
        """One row's channels finalized at the tick ``cursor`` of a run still
        going: as a completed run whose horizon was ``min(cursor, ticks)``."""
        return self.finalize_row(flat, min(int(cursor), self.ticks))

    def stream_rows(self, flat: np.ndarray, t0: int, t1: int) -> dict:
        """The windowed-series rows completed by advancing the cursor from
        ``t0`` to ``t1`` (a window is complete once the cursor passes its
        end, or the horizon): consecutive calls emit ``[t0 // stride, t1 //
        stride)``, so any chunk tiling of ``[0, ticks)`` concatenates to the
        finalize-time arrays.  ``{channel.key: {lo, hi, stride, util,
        qlen_sum, stats}}`` for every ``WindowedSeries``; empty when none
        completed."""
        flat = np.asarray(flat)
        assert flat.shape == (self.size,), (flat.shape, self.size)
        views = self._views(flat)
        out: dict = {}
        for ch, built in self._built:
            if not isinstance(ch, WindowedSeries):
                continue
            stride, nw = built["stride"], built["nw"]
            lo = min(nw, int(t0) // stride)
            hi = nw if int(t1) >= self.ticks else min(nw, int(t1) // stride)
            if hi <= lo:
                continue
            v = views[id(ch)]
            out[ch.key] = {
                "lo": lo, "hi": hi, "stride": stride,
                "util": np.asarray(v["util"][lo:hi]),
                "qlen_sum": np.asarray(v["qlen_sum"][lo:hi]),
                "stats": np.asarray(v["stats"][lo:hi]),
            }
        return out


# ---------------------------------------------------------------------------
# Sketch statistics.
# ---------------------------------------------------------------------------


def sketch_percentile(counts: np.ndarray, edges: np.ndarray, q: float, zeros: int = 0) -> float:
    """Percentile from a histogram sketch, exact to bin resolution: the
    lower edge of the bin holding the nearest-rank-above order statistic
    (numpy's ``method="higher"``), within one bin width of the exact value
    and exact for unit-width linear bins.  ``zeros`` counts observations
    below ``edges[0]`` never accumulated (the qlen channel's).  An empty
    sketch gives NaN; ``q`` outside [0, 100] and negative counts raise."""
    if not 0.0 <= float(q) <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    if int(zeros) < 0:
        raise ValueError(f"zeros must be >= 0, got {zeros!r}")
    counts = np.asarray(counts, np.int64)
    if counts.size and int(counts.min()) < 0:
        raise ValueError("histogram counts must be non-negative")
    total = int(counts.sum()) + int(zeros)
    if total == 0:
        return float("nan")  # empty sketch: percentile undefined
    rank = math.ceil(q / 100.0 * (total - 1))  # 0-indexed order stat
    if rank < zeros:
        return 0.0
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, rank - zeros + 1, side="left"))
    if b >= len(counts):  # inconsistent zeros / counts upstream
        return float("nan")
    return float(edges[b])


def sketch_bin_index(edges: np.ndarray, value: float) -> int:
    """The bin a value falls into under the channel's binning rule (clipped
    at both ends)."""
    idx = int(np.searchsorted(np.asarray(edges), value, side="right")) - 1
    return max(0, min(idx, len(edges) - 2))
