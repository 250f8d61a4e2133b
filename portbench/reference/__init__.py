"""The benchmark's plain reference for the simulator's rows.

The modules beside this file are a frozen copy of the port's plain
formulation: the tick body of ``netsim/engine.py``, the load balancers, the
topology, the telemetry and each kernel's plain version (``ref.py``), with
``ops.py`` sending every kernel call to its plain version on whatever device
the tensors are.  It imports nothing of the program and nothing of JAX.
Being a copy of the port's own formulation, it is only as independent as
its witness: ``witness_fig06_ft128.json`` holds the digest of every leaf of
its rows at the fig06 cell's fabric and traffic, taken when they were found
equal bit for bit to the JAX package's sweep over the same batch, and
``test_portbench_witness.py`` holds it to them.

``Rows`` steps any subset of a batch's rows from tick 0 as the sweep
engine's bucket would hold them: the configuration pinned to the bucket's
shapes (worked out here again from the batch, as the sweep's packer does),
a ``SwitchLB`` over the batch's load balancers with each row's branch, each
row's key from its seed, the default telemetry in summary mode.
``cc_dtype`` stores the congestion-control state (``c_cwnd``, ``c_alpha``,
float32 in the configuration) in a narrower float after every tick: the
control that has to come out as not correct.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .config import SimConfig
from .engine import FailureSchedule, Simulator, Workload
from .load_balancers import SwitchLB, make_lb
from .telemetry import TelemetrySpec
from .tree import tree_map


def _pow2(n: int) -> int:
    return int(2 ** np.ceil(np.log2(max(int(n), 1))))


def bucket_config(fabric: dict, batch) -> tuple[SimConfig, FailureSchedule, np.ndarray]:
    """The batch's configuration pinned to its bucket's shapes, its live
    failure windows padded to the bucket's rows and its padded watch list,
    by the sweep packer's rules (``netsim/sweep.py``: ``_quantize``,
    ``_build_program``, ``truncate_dead``, ``_pad_watch``)."""
    cfg = SimConfig(**fabric)
    s, e = batch.f_start, batch.f_end
    live = (e > s) & (s < batch.horizon)
    fs = FailureSchedule(batch.f_queue[live], s[live], e[live], batch.f_kind[live])
    f_b = _pow2(max(len(fs), 1))
    msg_max = int(batch.msg_pkts.max())
    msg_b = int(min(cfg.max_msg_pkts, max(_pow2(max(msg_max, 2)), 2)))
    cph = int(np.bincount(batch.src, minlength=cfg.n_hosts).max())
    w = _pow2(max(len(batch.watch), 1))
    watch = np.concatenate([batch.watch, np.full(w - len(batch.watch), batch.watch[-1], np.int32)])
    return (cfg.replace(msg_slots=msg_b, conns_per_host=cph, failure_slots=f_b),
            fs.pad_to(f_b), watch.astype(np.int32))


class Rows:
    """Rows ``row_ids`` (indices into ``batch.rows``) of one batch, stepped
    by the frozen formulation on ``device``.  The interface is the harness's
    program interface: ``carry0``, ``step``, ``quiescent``, ``take_rows``."""

    def __init__(self, fabric: dict, batch, row_ids, device, cc_dtype=None):
        cfg, fs, watch = bucket_config(fabric, batch)
        wl = Workload(batch.src, batch.dst, batch.msg_pkts, batch.start, batch.dep)
        lbs = []
        for name, kw in batch.lbs:
            kw = dict(kw)
            kw.setdefault("evs_size", cfg.evs_size)
            lbs.append(make_lb(name, **kw))
        self.lb = SwitchLB(lbs)
        rows = [batch.rows[i] for i in row_ids]
        self.sim = Simulator(cfg, wl, self.lb, failures=fs, watch_queues=watch,
                             seed=rows[0][1], device=device)
        self.device = self.sim.device
        self.keys = torch.stack([rng.PRNGKey(s, device=self.device) for _, s in rows])
        self.branch = np.asarray([b for b, _ in rows], np.int32)
        self.summary = batch.collect == "summary"
        self.tel_prog = TelemetrySpec.default().build(self.sim, batch.horizon) if self.summary else None
        self.horizon = batch.horizon
        self.cc_dtype = cc_dtype

    def carry0(self):
        rows = [self.sim.init_state(k) for k in self.keys]
        states = tree_map(lambda *leaves: torch.stack(leaves), *rows)
        states = states.replace(lb_state=self.lb.with_branch(states.lb_state, self.branch))
        return (states, self.tel_prog.init_rows(len(self.branch))) if self.summary else states

    def step(self, carry, t0: int, n: int):
        sim = self.sim
        states, tel = carry if self.summary else (carry, None)
        chunk = sim.draw_chunk(self.keys.shape[0])
        for c0 in range(t0, t0 + n, chunk):
            m = min(chunk, t0 + n - c0)
            draws = sim.tick_draws(self.keys, c0, m)
            for i in range(m):
                if self.summary:
                    states, probe = sim.step_probe_rows(states, c0 + i, draws.row(i))
                    self.tel_prog.update(tel, probe)
                else:
                    states, _ = sim.step_rows(states, c0 + i, draws.row(i), trace=False)
                if self.cc_dtype is not None:
                    states = states.replace(
                        c_cwnd=states.c_cwnd.to(self.cc_dtype).to(torch.float32),
                        c_alpha=states.c_alpha.to(self.cc_dtype).to(torch.float32))
        return (states, tel) if self.summary else states

    def quiet_rows(self, carry, t: int) -> np.ndarray:
        """Each row's fixed point at tick ``t`` (``SweepEngine._quiescent``'s
        rule, per row): no packet slot held and no connection that can
        still start before the horizon with work left, or past its horizon."""
        st = carry[0] if self.summary else carry
        scn = self.sim.scn
        dep = scn.conn_dep.clamp(0, scn.conn_src.shape[-1] - 1).long().expand_as(st.c_done)
        dep_ok = (scn.conn_dep < 0) | torch.gather(st.c_done, 1, dep)
        startable = (scn.conn_start < self.horizon) & dep_ok
        has_work = (st.c_rtx_count > 0) | (st.c_next_new < scn.conn_msg)
        active = startable & ~st.c_done & has_work
        quiet = (st.fl_count == self.sim.NP) & ~active.any(dim=-1)
        return (quiet | (self.horizon <= t)).cpu().numpy()

    def quiescent(self, carry, t: int) -> bool:
        return bool(self.quiet_rows(carry, t).all())

    def take_rows(self, carry, rows):
        """The rows' state (and telemetry carry) on the host."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        states, tel = carry if self.summary else (carry, None)
        st = tree_map(lambda x: x.index_select(0, idx).cpu(), states)
        return st, (tel.index_select(0, idx).cpu() if tel is not None else None)
