"""Preemption-proof soak runtime: checkpointed sweeps with bit-exact resume
and mid-run fault injection (counterpart of ``repro.netsim.soak``).

``SweepEngine.run`` is the batch path: declare the grid, run it to its
horizon, read the figures.  Long soak runs need three things more:

* **Preemption-proofness.**  A run killed at any instant resumes
  bit-identically: a resumed run's summaries, sketches, traces and flight
  parts equal the uninterrupted run's.
* **A scenario API.**  ``advance`` / ``inject`` / ``inspect``: drive
  simulated time, inject failure events mid-run, read live telemetry
  between chunks.
* **One semantics for injected and declared failures.**  An event injected
  at tick *t* behaves exactly like the same event declared in the case's
  ``FailureSchedule``: the padded schedule is re-materialised through
  ``FailureSchedule.merge`` (the path static composites take).

``SoakRunner`` layers these over the sweep's chunk primitives
(``bucket_carry`` / ``run_chunk`` / ``finalize_bucket``): time advances in
chunks, and each chunk boundary snapshots every bucket's carry (the rows'
states, the telemetry carry, the flight ring) and RNG keys through
``repro_torch.checkpoint``.  ``resume()`` restores the newest committed
snapshot (the keys from the snapshot, never derived again), replays the
injection log through the one merge path, and continues.

Bit-exactness rests on two facts: the sweep's chunks tile ``[0, ticks)``
with the same result however they are cut (the absolute tick is passed
in), and device -> npz -> device round trips are exact for the int32 /
int64 / bool / float32 tensors of the carries.  Part files (``traces/``,
``flight/``) keep the reference's names and array keys, so
``tools/trace_export.py`` and ``benchmarks/soak_dashboard.py`` read the
port's ``flight/`` directory as they read the reference's.

Injection headroom: build the engine with ``min_failure_slots`` big enough
for the deltas to inject; the reserved inert rows let the merged schedule
be re-materialised without a shape change, and make an injected run and
its statically declared equivalent plan identical buckets.

    eng = SweepEngine(cfg, cases, min_failure_slots=16)       # on the card
    soak = SoakRunner(eng, SoakConfig(chunk=120, ckpt_dir="ck", trace=TraceSpec()))
    soak.advance(240); soak.inject(failures.spine_down(cfg, 0, start=240))
    while not soak.done: soak.advance(120)
    res = soak.result()
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.netsim.config import TICK_NS
from repro_torch.netsim.engine import FailureSchedule, TickTrace
from repro_torch.netsim.failures import truncate_dead
from repro_torch.netsim.sweep import SweepEngine, SweepResult
from repro_torch.netsim.telemetry import TelemetrySpec
from repro_torch.netsim.topology import Topology
from repro_torch.netsim.tracer import CODE_NAMES, TraceSpec

_TRACE_RE = re.compile(r"^trace_b(\d+)_t(\d{9})_n(\d+)\.npz$")
_FLIGHT_RE = re.compile(r"^flight_b(\d+)_t(\d{9})_n(\d+)\.npz$")
_F_FIELDS = ("f_queue", "f_start", "f_end", "f_kind", "f_param")


@dataclasses.dataclass(frozen=True)
class SoakConfig:
    """Knobs for one soak run.

    chunk:          ticks per chunk; every chunk boundary is a checkpoint
                    (and where ``advance`` yields back to the host).
    ckpt_dir:       snapshot root (``step_<cursor>`` directories); None
                    disables checkpointing (the scenario API alone).
    keep:           keep the newest K committed snapshots.
    collect:        "none" | "summary" | "full", as ``SweepEngine.run``;
                    "full" writes each chunk's trace to ``ckpt_dir/traces``
                    so that a resumed run has the whole stream.
    telemetry:      TelemetrySpec for collect="summary" (the default spec
                    when None).
    trace:          optional ``tracer.TraceSpec`` (summary mode only): the
                    flight-recorder ring per row, drained at every chunk
                    boundary into an atomic ``flight/flight_b*_t*_n*.npz``
                    part before the checkpoint commits.  Observation-only.
    stream_series:  also write the chunk's completed telemetry windows
                    into each flight part.
    async_save:     copy the snapshot to the host synchronously, write it
                    in a background thread (``checkpoint.save_async``); the
                    runner joins, and re-raises its errors, before the next
                    save or the result.
    save_retries:   retries of a save on a transient ``OSError``.
    save_backoff_s: base backoff between retries (doubles each attempt).
    """

    chunk: int = 256
    ckpt_dir: Optional[str] = None
    keep: int = 3
    collect: str = "summary"
    telemetry: Optional[TelemetrySpec] = None
    trace: Optional[TraceSpec] = None
    stream_series: bool = True
    async_save: bool = False
    save_retries: int = 2
    save_backoff_s: float = 0.05


class SoakRunner:
    """Drives a ``SweepEngine`` through simulated time in checkpointed
    chunks; see the module docstring."""

    def __init__(self, engine: SweepEngine, config: SoakConfig | None = None):
        self.engine = engine
        self.config = config or SoakConfig()
        if self.config.collect not in ("none", "summary", "full"):
            raise ValueError(f"bad collect {self.config.collect!r}")
        self.spec = ((self.config.telemetry or TelemetrySpec.default())
                     if self.config.collect == "summary" else None)
        self.trace = self.config.trace
        if self.trace is not None and self.config.collect != "summary":
            raise ValueError(
                "SoakConfig.trace requires collect='summary' (the flight "
                "recorder rides the telemetry carry contract)"
            )
        self.cursor = 0
        self.injections: list[dict] = []
        self.fingerprint = self._fingerprint()
        # one carry per bucket, advanced in lock-step with `cursor` (a bucket
        # past its own horizon stops advancing)
        self.carries = [engine.bucket_carry(b, self.config.collect, self.spec, self.trace)
                        for b in engine.buckets]
        # collect="full": per bucket [(t0, n, TickTrace of CPU tensors)] in
        # window order, mirrored as part files under ckpt_dir/traces
        self.trace_parts: list[list[tuple[int, int, Any]]] = [[] for _ in engine.buckets]
        # tracing: per bucket and kept row, the ring cursor through which
        # events have been flushed to part files (on resume, read back from
        # the restored ring: flushes always precede the commit)
        self._flight_cursors: list[np.ndarray] = [
            np.zeros((b.n_rows,), np.int64) for b in engine.buckets]
        self._row_index: dict = {}  # (device, rows) -> index tensor
        self._flight_meta_written = False
        self._pending: Optional[ckpt.SaveHandle] = None
        self._finalized = False

    # ------------------------------------------------------------------
    @property
    def horizon(self) -> int:
        """The grid's largest cell horizon: ``advance`` stops there."""
        return max(b.ticks for b in self.engine.buckets)

    @property
    def done(self) -> bool:
        return self.cursor >= self.horizon

    def _fingerprint(self) -> str:
        """Digest of what shapes execution: the pack plan, the pinned
        config, every case's scenario arrays and the collect mode.  A
        snapshot resumes only onto an engine with the same digest: anything
        else would change padding, and padding changes the random draws."""
        h = hashlib.sha256()
        eng = self.engine
        h.update(eng.plan.describe().encode())
        h.update(repr(eng.cfg).encode())
        h.update(str(eng.min_failure_slots).encode())
        for case in eng.cases:
            h.update(repr((case.name, case.ticks, case.lb, sorted(case.lb_kwargs.items()),
                           tuple(int(s) for s in case.seeds))).encode())
            wl = case.workload
            for a in (wl.src, wl.dst, wl.msg_pkts, wl.start, wl.dep):
                h.update(np.ascontiguousarray(a, np.int64).tobytes())
            fs = case.failures or FailureSchedule.none()
            for a in (fs.queue, fs.start, fs.end, fs.kind, fs.param):
                h.update(np.ascontiguousarray(a, np.int64).tobytes())
            h.update(np.ascontiguousarray(eng._watch_for(case), np.int64).tobytes())
        h.update(repr((self.config.collect, self.spec)).encode())
        # only when tracing, so that trace-off digests stay as they were; the
        # ring carry changes the snapshot's trees
        if self.trace is not None:
            h.update(repr(self.trace).encode())
        return h.hexdigest()

    # ------------------------------------------------------------------
    # Scenario API.
    # ------------------------------------------------------------------
    def advance(self, n_ticks: int) -> int:
        """Advance simulated time by up to ``n_ticks`` (stopping at the
        grid's horizon), checkpointing at every chunk boundary crossed.
        Returns the new cursor."""
        self._alive()
        target = min(self.cursor + int(n_ticks), self.horizon)
        while self.cursor < target:
            step = min(self.config.chunk, target - self.cursor)
            t0 = self.cursor
            for bi, bucket in enumerate(self.engine.buckets):
                n = min(t0 + step, bucket.ticks) - t0
                if n <= 0:
                    continue  # bucket already at its own horizon
                carry, traces = self.engine.run_chunk(
                    bucket, self.carries[bi], t0, n, self.config.collect, self.spec, self.trace)
                self.carries[bi] = carry
                if self.config.collect == "full":
                    part = TickTrace(*(f.cpu() for f in traces))
                    self.trace_parts[bi].append((t0, n, part))
                    self._write_trace_part(bi, t0, n, part)
                if self.trace is not None:
                    self._flush_flight_part(bi, t0, n)
            self.cursor = t0 + step
            self._checkpoint()
        return self.cursor

    def inject(self, delta: FailureSchedule) -> None:
        """Inject failure events into the running grid at the current
        cursor.  The delta is validated and merged into every still-active
        cell's schedule through ``FailureSchedule.merge``, then the padded
        per-row scenario arrays are re-materialised (no shape change: the
        rows land in the engine's ``min_failure_slots`` headroom).  The
        injection joins the log that snapshots carry, and a checkpoint is
        committed at once."""
        self._alive()
        self._apply_delta(delta, self.cursor)
        self.injections.append({
            "at_tick": int(self.cursor),
            "queue": np.asarray(delta.queue, np.int32).tolist(),
            "start": np.asarray(delta.start, np.int32).tolist(),
            "end": np.asarray(delta.end, np.int32).tolist(),
            "kind": np.asarray(delta.kind, np.int32).tolist(),
            "param": np.asarray(delta.param, np.int32).tolist(),
        })
        self._checkpoint()

    def _alive(self) -> None:
        if self._finalized:
            raise RuntimeError("runner already finalized")

    def _gather_rows(self, rows: tuple, arr: torch.Tensor) -> np.ndarray:
        """Only the requested rows of a ``(R, size)`` carry, gathered on the
        device and copied to the host (the index made once per row set)."""
        key = (arr.device, rows)
        idx = self._row_index.get(key)
        if idx is None:
            idx = self._row_index[key] = torch.as_tensor(rows, dtype=torch.int64,
                                                         device=arr.device)
        return arr.index_select(0, idx).cpu().numpy()

    def inspect(self) -> dict[str, dict]:
        """Live per-cell view at the current cursor, without disturbing the
        run: ``{cell: {cursor, ticks, done, telemetry[, flight]}}``, the
        telemetry (summary mode, seed 0) finalized at ``min(cursor, cell
        ticks)`` and the flight (when tracing) the row's decoded ring."""
        out: dict[str, dict] = {}
        summary = self.config.collect == "summary"
        for bi, bucket in enumerate(self.engine.buckets):
            tel = trc = None
            rows = tuple(int(c.rows[0]) for c in bucket.cells)
            if summary:
                tel_prog = self.engine._tel_prog(bucket.program, self.spec)
                tel = self._gather_rows(rows, self.carries[bi][1])
            if self.trace is not None:
                trc_prog = self.engine._trc_prog(bucket.program, self.trace)
                trc = self._gather_rows(rows, self.carries[bi][2])
            for ci, c in enumerate(bucket.cells):
                cell_cursor = min(self.cursor, c.case.ticks)
                info: dict[str, Any] = {
                    "cursor": cell_cursor, "ticks": c.case.ticks,
                    "done": cell_cursor >= c.case.ticks,
                }
                if summary:
                    info["telemetry"] = tel_prog.live_row(tel[ci], cell_cursor)
                if trc is not None:
                    info["flight"] = trc_prog.decode_row(trc[ci])
                out[c.case.name] = info
        return out

    def result(self) -> SweepResult:
        """Finalize every bucket and return the ``SweepResult`` view; the
        grid must have reached its horizon (``inspect`` reads a partial
        one)."""
        if not self.done:
            raise RuntimeError(f"grid not finished: cursor {self.cursor} < horizon "
                               f"{self.horizon}; advance() further or use inspect()")
        self._join_pending()
        full = self.config.collect == "full"
        for bi, bucket in enumerate(self.engine.buckets):
            chunks = [p for _, _, p in self._contiguous_parts(bi)] if full else None
            self.engine.finalize_bucket(bucket, self.carries[bi], self.config.collect,
                                        bucket.ticks, chunks, self.spec, self.trace)
            self.carries[bi] = None  # the host copies own the data now
        self._finalized = True
        return SweepResult(self.engine)

    # ------------------------------------------------------------------
    # Injection internals.
    # ------------------------------------------------------------------
    def _apply_delta(self, delta: FailureSchedule, at_tick: int) -> None:
        topo = Topology.build(self.engine.cfg)
        # validate against every still-active cell before changing any: a
        # partly applied injection could never match a static run
        staged: list[tuple[int, Any, FailureSchedule]] = []
        for bi, bucket in enumerate(self.engine.buckets):
            f_slots = bucket.plan.key[4]
            for c in bucket.cells:
                if c.case.ticks <= at_tick:
                    continue  # cell finished; the delta can never act on it
                live = truncate_dead(c.padded_fs, c.case.ticks)
                merged = live.merge(delta, at_tick=at_tick, n_queues=topo.n_queues)
                live_merged = truncate_dead(merged, c.case.ticks)
                if len(live_merged) > f_slots:
                    raise ValueError(
                        f"cell {c.case.name!r}: merged schedule needs {len(live_merged)} "
                        f"failure rows but the bucket reserved {f_slots}; build the engine "
                        f"with min_failure_slots >= {len(live_merged)} to leave injection "
                        "headroom"
                    )
                staged.append((bi, c, live_merged.pad_to(f_slots)))
        # commit: re-materialise the padded schedules into the scenario
        # arrays, one host round trip per touched bucket
        for bi in sorted({bi for bi, _, _ in staged}):
            bucket = self.engine.buckets[bi]
            host = {name: getattr(bucket.scn, name).cpu().numpy().copy() for name in _F_FIELDS}
            for sbi, c, padded in staged:
                if sbi != bi:
                    continue
                c.padded_fs = padded
                for row in c.rows:
                    for name, f in zip(_F_FIELDS, ("queue", "start", "end", "kind", "param")):
                        host[name][row] = getattr(padded, f)
            # pad rows repeat row 0 at build time; keep that, so that an
            # injected bucket is indistinguishable from a fresh build
            for name in host:
                host[name][bucket.n_rows:] = host[name][0]
            dev = bucket.scn.f_queue.device
            bucket.scn = bucket.scn._replace(
                **{k: torch.as_tensor(v, device=dev) for k, v in host.items()})

    # ------------------------------------------------------------------
    # Checkpoint / resume.
    # ------------------------------------------------------------------
    def _trees(self) -> dict[str, Any]:
        trees: dict[str, Any] = {}
        for bi, bucket in enumerate(self.engine.buckets):
            trees[f"b{bi}_carry"] = self.carries[bi]
            trees[f"b{bi}_keys"] = bucket.keys
        return trees

    def _extra(self) -> dict:
        return {"soak": {
            "fingerprint": self.fingerprint,
            "cursor": int(self.cursor),
            "collect": self.config.collect,
            "chunk": int(self.config.chunk),
            "injections": self.injections,
        }}

    def _join_pending(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.join()  # re-raises background IO failures

    def _checkpoint(self) -> None:
        cfg = self.config
        if cfg.ckpt_dir is None:
            return
        path = os.path.join(cfg.ckpt_dir, f"step_{self.cursor}")
        self._join_pending()
        if cfg.async_save:
            # prune now, while no save is in flight: pruning sweeps stale
            # staging directories and must never race a live one
            ckpt.prune(cfg.ckpt_dir, cfg.keep)
            self._pending = ckpt.save_async(
                path, self.cursor, self._trees(), extra=self._extra(),
                retries=cfg.save_retries, backoff_s=cfg.save_backoff_s)
        else:
            ckpt.save(path, self.cursor, self._trees(), extra=self._extra(),
                      retries=cfg.save_retries, backoff_s=cfg.save_backoff_s)
            ckpt.prune(cfg.ckpt_dir, cfg.keep)

    def resume(self) -> "SoakRunner":
        """Restore the newest committed snapshot under ``ckpt_dir`` into
        this freshly built runner: replay the injection log through the
        injection path, then load every bucket's carry and RNG keys from the
        snapshot.  Returns self."""
        cfg = self.config
        if cfg.ckpt_dir is None:
            raise ValueError("SoakConfig.ckpt_dir not set")
        if self.cursor != 0 or self.injections:
            raise RuntimeError("resume() must be called on a fresh runner")
        path = ckpt.latest(cfg.ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no committed snapshot under {cfg.ckpt_dir}")
        meta = ckpt.read_manifest(path)["soak"]
        if meta["fingerprint"] != self.fingerprint:
            raise ValueError(
                "snapshot belongs to a different sweep: plan/scenario fingerprint "
                "mismatch (engine cases, config, packing or collect mode changed since "
                "the snapshot was written)"
            )
        # injections first: they rebuild the padded schedules and scenario
        # arrays the carries continue on
        for inj in meta["injections"]:
            delta = FailureSchedule(
                queue=np.asarray(inj["queue"], np.int32),
                start=np.asarray(inj["start"], np.int32),
                end=np.asarray(inj["end"], np.int32),
                kind=np.asarray(inj["kind"], np.int32),
                param=np.asarray(inj.get("param", np.zeros(len(inj["queue"]), np.int32)),
                                 np.int32),
            )
            self._apply_delta(delta, int(inj["at_tick"]))
            self.injections.append(inj)
        trees, step = ckpt.restore(path, self._trees())
        for bi, bucket in enumerate(self.engine.buckets):
            self.carries[bi] = trees[f"b{bi}_carry"]
            bucket.keys = trees[f"b{bi}_keys"]
        self.cursor = int(step)
        if self.config.collect == "full":
            self._load_trace_parts()
        if self.trace is not None:
            self._load_flight_state()
        return self

    # ------------------------------------------------------------------
    # Full-trace streaming (collect="full").
    # ------------------------------------------------------------------
    def _traces_dir(self) -> Optional[str]:
        if self.config.ckpt_dir is None:
            return None
        d = os.path.join(self.config.ckpt_dir, "traces")
        os.makedirs(d, exist_ok=True)
        return d

    def _write_trace_part(self, bi: int, t0: int, n: int, part: TickTrace) -> None:
        """One chunk's trace as an atomic npz part file.  A window run
        again after a resume writes the same values, and parts at or past
        the restored cursor are deleted on resume anyway."""
        d = self._traces_dir()
        if d is None:
            return
        fname = f"trace_b{bi}_t{t0:09d}_n{n}.npz"
        tmp = os.path.join(d, fname + ".tmp")
        with open(tmp, "wb") as f:  # a handle, or np.savez appends ".npz"
            np.savez(f, **{k: v.numpy() for k, v in zip(TickTrace._fields, part)})
        os.replace(tmp, os.path.join(d, fname))

    def _load_trace_parts(self) -> None:
        """Rebuild the per-bucket part lists from disk: keep the parts below
        the restored cursor, delete the rest (their windows run again)."""
        d = self._traces_dir()
        parts: dict[int, list[tuple[int, int, Any]]] = {}
        for fname in sorted(os.listdir(d)):
            m = _TRACE_RE.match(fname)
            if m is None:
                if fname.endswith(".tmp"):
                    os.unlink(os.path.join(d, fname))
                continue
            bi, t0, n = int(m.group(1)), int(m.group(2)), int(m.group(3))
            p = os.path.join(d, fname)
            if t0 >= self.cursor:
                os.unlink(p)
                continue
            with np.load(p) as data:
                part = TickTrace(*[torch.as_tensor(data[k]) for k in TickTrace._fields])
            parts.setdefault(bi, []).append((t0, n, part))
        self.trace_parts = [sorted(parts.get(bi, []), key=lambda p: p[:2])
                            for bi in range(len(self.engine.buckets))]

    # ------------------------------------------------------------------
    # Flight-recorder streaming (trace=TraceSpec(...)).
    # ------------------------------------------------------------------
    def _flight_dir(self) -> Optional[str]:
        if self.config.ckpt_dir is None:
            return None
        d = os.path.join(self.config.ckpt_dir, "flight")
        os.makedirs(d, exist_ok=True)
        return d

    def _write_flight_meta(self) -> None:
        """The sidecar mapping part files back to cells: the event code
        table, the tick duration and each bucket's kept row -> cell."""
        d = self._flight_dir()
        if d is None or self._flight_meta_written:
            return
        meta = {
            "tick_ns": TICK_NS,
            "ring": int(self.trace.ring),
            "marker_every": int(self.trace.marker_every),
            "codes": {str(k): v for k, v in CODE_NAMES.items()},
            "buckets": [
                {
                    "cells": [
                        {"name": c.case.name, "ticks": int(c.case.ticks),
                         "seeds": [int(s) for s in c.case.seeds],
                         "rows": [int(r) for r in c.rows]}
                        for c in b.cells
                    ],
                    "n_rows": int(b.n_rows),
                }
                for b in self.engine.buckets
            ],
        }
        tmp = os.path.join(d, "flight_meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(d, "flight_meta.json"))
        self._flight_meta_written = True

    def _flush_flight_part(self, bi: int, t0: int, n: int) -> None:
        """Drain the window's new ring events of every kept row of one
        bucket into an atomic ``flight_b*_t*_n*.npz`` part, before the
        window's checkpoint commits.  ``lost`` counts ring overwrites within
        the window (more than ``ring`` pushes between flushes)."""
        d = self._flight_dir()
        if d is None:
            return
        self._write_flight_meta()
        bucket = self.engine.buckets[bi]
        trc_prog = self.engine._trc_prog(bucket.program, self.trace)
        rows = tuple(range(bucket.n_rows))
        flat = self._gather_rows(rows, self.carries[bi][2])
        since = self._flight_cursors[bi]
        ev_row, ev_seq, ev_tick, ev_code, ev_val = [], [], [], [], []
        cursor = np.zeros((bucket.n_rows,), np.int64)
        lost = np.zeros((bucket.n_rows,), np.int64)
        first_drop = np.zeros((bucket.n_rows,), np.int64)
        first_red = np.zeros((bucket.n_rows,), np.int64)
        for r in range(bucket.n_rows):
            ev = trc_prog.decode_row(flat[r], since=int(since[r]))
            cursor[r], lost[r] = ev["cursor"], ev["lost"]
            first_drop[r] = ev["first_drop_tick"]
            first_red[r] = ev["first_redeliver_tick"]
            ev_row.append(np.full(ev["seq"].shape, r, np.int32))
            ev_seq.append(ev["seq"])
            ev_tick.append(ev["tick"])
            ev_code.append(ev["code"])
            ev_val.append(ev["value"])
        part = {
            "row": np.concatenate(ev_row) if ev_row else np.zeros(0, np.int32),
            "seq": np.concatenate(ev_seq),
            "tick": np.concatenate(ev_tick),
            "code": np.concatenate(ev_code),
            "value": np.concatenate(ev_val),
            "since": since.copy(),
            "cursor": cursor,
            "lost": lost,
            "first_drop_tick": first_drop,
            "first_redeliver_tick": first_red,
        }
        if self.config.stream_series and self.spec is not None:
            tel_prog = self.engine._tel_prog(bucket.program, self.spec)
            tel = self._gather_rows(rows, self.carries[bi][1])
            per_row = [tel_prog.stream_rows(tel[r], t0, t0 + n) for r in range(bucket.n_rows)]
            for key, s in per_row[0].items():
                part[f"series_{key}_lo"] = np.asarray(s["lo"], np.int64)
                part[f"series_{key}_stride"] = np.asarray(s["stride"], np.int64)
                for f in ("util", "qlen_sum", "stats"):
                    part[f"series_{key}_{f}"] = np.stack([pr[key][f] for pr in per_row])
        fname = f"flight_b{bi}_t{t0:09d}_n{n}.npz"
        tmp = os.path.join(d, fname + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **part)
        os.replace(tmp, os.path.join(d, fname))
        self._flight_cursors[bi] = cursor

    def _load_flight_state(self) -> None:
        """On resume: the flushed-through cursors from the restored rings
        (flushes precede the commit, so they agree), and the parts at or
        past the restored cursor deleted (their windows run again)."""
        for bi, bucket in enumerate(self.engine.buckets):
            flat = self._gather_rows(tuple(range(bucket.n_rows)), self.carries[bi][2])
            self._flight_cursors[bi] = np.asarray(flat[:, 0], np.int64)
        d = self._flight_dir()
        if d is None:
            return
        for fname in sorted(os.listdir(d)):
            m = _FLIGHT_RE.match(fname)
            if m is None:
                if fname.endswith(".tmp"):
                    os.unlink(os.path.join(d, fname))
                continue
            if int(m.group(2)) >= self.cursor:
                os.unlink(os.path.join(d, fname))
        self._flight_meta_written = False  # written again (same bytes) at the next flush

    def _contiguous_parts(self, bi: int) -> list[tuple[int, int, Any]]:
        """The bucket's trace parts in window order; they must tile ``[0,
        bucket.ticks)`` exactly (a gap means part files were lost)."""
        bucket = self.engine.buckets[bi]
        parts = sorted(self.trace_parts[bi], key=lambda p: p[:2])
        want = 0
        for t0, n, _ in parts:
            if t0 != want:
                raise RuntimeError(f"trace stream for bucket {bi} has a gap: expected a part "
                                   f"at t0={want}, found t0={t0}")
            want = t0 + n
        if want != bucket.ticks:
            raise RuntimeError(f"trace stream for bucket {bi} ends at {want}, horizon is "
                               f"{bucket.ticks}")
        return parts
