"""Rows with their own scenarios (``ScenarioArrays`` with a leading row axis)
in the port's one tick body, against the JAX package on the CPU.

Three rows of FATTREE_32_CI at one set of pinned shapes differ in workload
(destinations, message sizes, start ticks, prerequisites), failure schedule
(down, degraded and gray-loss windows) and watch list.  Tick by tick, every
``SimState`` leaf and every ``Probe`` field of each row equals
``jax.vmap(sim.step_probe, in_axes=(0, None, 0, 0))`` over the stacked JAX
``ScenarioArrays`` (tolerance 0), and each row's final state equals a serial
port run of its own scenario.  Then the plain ``next_queue`` with one
connection table per row against one-row calls, and the shape checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro.core import make_lb as j_make_lb
from repro.netsim import Simulator as JSim
from repro.netsim import Topology as JTopology
from repro.netsim import TelemetrySpec as JSpec
from repro.netsim import engine as jengine
from repro.netsim import failures as jfail
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.core import make_lb as t_make_lb
from repro_torch.kernels import ref
from repro_torch.netsim import FleetRunner, Simulator, TelemetrySpec, Topology, interop
from repro_torch.netsim import metrics as tmetrics
from repro_torch.netsim import engine as tengine
from repro_torch.netsim import failures as tfail
from repro_torch.netsim import stack_scenarios
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

TICKS = 400
SEEDS = (2, 5, 9)
PIN = dict(msg_slots=64, conns_per_host=2, failure_slots=6)
LB_KW = dict(evs_size=J_CFG.evs_size, freezing_timeout=250)


def row_workloads(mod):
    """Three 32-connection workloads: a permutation, a tornado with
    staggered starts, and a permutation whose second half waits for the
    first (prerequisites)."""
    rs = np.random.RandomState(0)
    w = []
    d0 = (np.arange(32) + 1 + rs.randint(0, 30, size=32)) % 32
    d0 = np.where(d0 == np.arange(32), (d0 + 1) % 32, d0)
    w.append(dict(dst=d0, msg=rs.randint(8, 49, size=32), start=np.zeros(32), dep=-np.ones(32)))
    w.append(dict(dst=(np.arange(32) + 16) % 32, msg=np.full(32, 64), start=rs.randint(0, 60, 32),
                  dep=-np.ones(32)))
    dep = -np.ones(32)
    dep[16:] = np.arange(16)
    d2 = (np.arange(32) + 5) % 32
    w.append(dict(dst=d2, msg=rs.randint(4, 33, size=32), start=np.zeros(32), dep=dep))
    i32 = lambda a: np.asarray(a, np.int32)
    return [mod.Workload(src=i32(np.arange(32)), dst=i32(x["dst"]), msg_pkts=i32(x["msg"]),
                         start=i32(x["start"]), dep=i32(x["dep"]), name=f"row{b}")
            for b, x in enumerate(w)]


def row_failures(mod, ups):
    """Each row's schedule: two uplinks down, one degraded plus one down,
    one gray-loss uplink (p = 0.3) and one down."""
    return [
        mod.link_down(ups[:2], 60, 2**30),
        mod.FailureSchedule.concat(mod.link_degraded([ups[2]], 20, 300),
                                   mod.link_down([ups[5]], 100, 250)),
        mod.FailureSchedule.concat(mod.gray_loss([ups[1]], 10, 350, 0.3),
                                   mod.link_down([ups[3]], 150, 2**30)),
    ]


def row_watch(ups):
    return [np.asarray(ups[:4]), np.asarray(ups[4:8]), np.asarray([ups[0], ups[3], ups[6], 7])]


def jax_rows():
    cfg = J_CFG.replace(**PIN)
    ups = [int(q) for q in JTopology.build(cfg).t0_up_queues(0)]
    return [JSim(cfg, wl, j_make_lb("reps", **LB_KW), failures=fs, watch_queues=w, seed=s)
            for wl, fs, w, s in zip(row_workloads(jengine), row_failures(jfail, ups),
                                    row_watch(ups), SEEDS)]


def port_rows():
    cfg = T_CFG.replace(**PIN)
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)]
    return [Simulator(cfg, wl, t_make_lb("reps", **LB_KW), failures=fs, watch_queues=w, seed=s,
                      device="cpu")
            for wl, fs, w, s in zip(row_workloads(tengine), row_failures(tfail, ups),
                                    row_watch(ups), SEEDS)]


def test_heterogeneous_rows_match_jax_vmapped_step_probe_tick_by_tick():
    jsims, tsims = jax_rows(), port_rows()
    js = jsims[0]
    jscn = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[s.scn for s in jsims])
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    jstates = jax.vmap(js.init_state)(jkeys)
    jprog = JSpec.default(stride=37).build(js, TICKS)
    jtel = jnp.tile(jprog.init()[None], (len(SEEDS), 1))

    @jax.jit
    def jstep(states, t, tel):
        new, probe = jax.vmap(js.step_probe, in_axes=(0, None, 0, 0))(states, t, jkeys, jscn)
        return new, probe, jax.vmap(jprog.update)(tel, probe)

    fleet = FleetRunner(T_CFG.replace(**PIN), tsims[0].wl, t_make_lb("reps", **LB_KW),
                        failures=tsims[0].failures, watch_queues=tsims[0].watch.numpy(),
                        seeds=SEEDS, device="cpu")
    sim = fleet.sim
    scn = stack_scenarios([s.scn for s in tsims])
    keys = fleet.base_keys()
    states = fleet.init_states()
    draws = sim.tick_draws(keys, 0, TICKS, scn)
    assert draws.u_gray is not None  # row 2's gray loss draws for every row
    prog = fleet.program(TelemetrySpec.default(stride=37), TICKS)
    tel = prog.init_rows(len(SEEDS))
    fields = ("q_len", "served", "watch_qlen", "watch_served", "stats_delta", "done_now", "fct")
    for t in range(TICKS):
        jstates, jprobe, jtel = jstep(jstates, jnp.int32(t), jtel)
        states, probe = sim.step_probe_rows(states, t, draws.row(t), scn)
        prog.update(tel, probe)
        assert probe.now == int(jprobe.now[0]) == t
        for f in fields:
            a, b = np.asarray(getattr(jprobe, f)), getattr(probe, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (t, f, a.shape, b.shape)
            np.testing.assert_array_equal(b, a, err_msg=f"tick {t}, probe field {f}")
        for i in range(len(SEEDS)):
            assert_states_equal(
                jax_state_to_numpy(jax.tree_util.tree_map(lambda x, i=i: x[i], jstates)),
                interop.sim_state_to_numpy(fleet.state_at(states, i)), f"tick {t}, row {i}")
    np.testing.assert_array_equal(tel.numpy(), np.asarray(jtel))
    stats = states.s_stats.numpy()
    assert stats[1, tengine.ST_DROPS_FAIL] > 0 and stats[2, tengine.ST_DROPS_FAIL] > 0
    assert int(states.c_done.sum()) > 0

    # each row is the serial port run of its own scenario, and so is its
    # summary (FCTs from the row's own start ticks)
    sums = fleet.summaries(states, scn=scn)
    for i, s in enumerate(tsims):
        st, tr = s.run(TICKS)
        a = interop.sim_state_to_numpy(fleet.state_at(states, i))
        assert_states_equal(a, interop.sim_state_to_numpy(st), f"row {i} vs its serial run")
        assert sums[i] == tmetrics.summarize(s, st, name=sim.wl.name), i
    # and FleetRunner.run with the rows' scenarios is the same tick
    st_run, tr = fleet.run(TICKS, scn=scn)
    assert tr.watch_qlen.shape == (TICKS, 3, 4)
    for i in range(len(SEEDS)):
        assert_states_equal(interop.sim_state_to_numpy(fleet.state_at(st_run, i)),
                            interop.sim_state_to_numpy(fleet.state_at(states, i)), f"run row {i}")


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("penalty", ["shared", "rows", None])
def test_next_queue_ref_per_row_tables_equal_one_row_calls(adaptive, penalty):
    """The plain ``next_queue`` with one ``(NC,)`` connection table pair per
    row (``(B, NC)``) equals B one-row calls, each with its row's tables."""
    topo = Topology.build(T_CFG)
    g, NQ, NH = topo.geometry, topo.n_queues, T_CFG.n_hosts
    rs = np.random.RandomState(3)
    B, K, NC, NP = 4, NQ + NH, 40, 700
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    a_idx = rs.randint(0, NP + 1, size=(B, K))
    hop = rs.randint(0, 4, size=(B, K))
    cur = np.where(hop == 0, -1, rs.randint(0, NQ, size=(B, K)))
    conn, ev = rs.randint(-2, NC + 2, size=(B, K)), rs.randint(0, 65536, size=(B, K))
    src, dst = rs.randint(0, NH, size=(B, NC)), rs.randint(0, NH, size=(B, NC))
    q_len = rs.randint(0, 4, size=(B, NQ))
    pen = {"shared": t(rs.randint(0, 2, size=NQ) * 340), "rows": t(rs.randint(0, 2, (B, NQ)) * 340),
           None: None}[penalty]
    args = [t(hop), t(cur), t(conn), t(ev), t(src), t(dst), t(q_len)]
    got = ref.next_queue_ref(g, *args, adaptive, q_penalty=pen, a_idx=t(a_idx), n_pkt=NP)
    for b in range(B):
        p = pen[b] if penalty == "rows" else pen
        one = ref.next_queue_ref(g, *(x[b] for x in args), adaptive, q_penalty=p,
                                 a_idx=t(a_idx)[b], n_pkt=NP)
        assert torch.equal(got[b], one), b


def test_rows_whose_shapes_differ_raise():
    """A row built at other shapes (NC, F, W, a message past the bitmap
    width), a row count that is not the state's, or draws made without the
    rows' gray loss: each raises before the tick."""
    tsims = port_rows()
    sim = tsims[0]
    cfg = sim.cfg
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)]
    scn = stack_scenarios([s.scn for s in tsims])
    states = FleetRunner(cfg, sim.wl, sim.lb, seeds=SEEDS, device="cpu").init_states()
    keys = torch.stack([sim.base_key] * 3)
    draws = sim.tick_draws(keys, 0, 1, scn).row(0)
    wl = sim.wl
    cut = tengine.Workload(*(np.asarray(x)[:20] for x in (wl.src, wl.dst, wl.msg_pkts, wl.start,
                                                           wl.dep)))
    long_msg = tengine.Workload(wl.src, wl.dst, np.full(32, 100, np.int32), wl.start, wl.dep)
    others = [
        ("conn_src", Simulator(cfg, cut, sim.lb, watch_queues=ups[:4], device="cpu")),
        ("f_queue", Simulator(cfg.replace(failure_slots=8), wl, sim.lb, watch_queues=ups[:4],
                              device="cpu")),
        ("watch", Simulator(cfg, wl, sim.lb, watch_queues=ups[:5], device="cpu")),
        ("MSG", Simulator(cfg.replace(msg_slots=128), long_msg, sim.lb, watch_queues=ups[:4],
                          device="cpu")),
    ]
    for what, other in others:
        with pytest.raises(ValueError, match=what):
            sim.step_rows(states, 0, draws, stack_scenarios([other.scn] * 3))
    with pytest.raises(ValueError, match="2 rows"):
        sim.step_rows(states, 0, draws, stack_scenarios([s.scn for s in tsims[:2]]))
    no_gray = sim.tick_draws(keys, 0, 1).row(0)
    assert no_gray.u_gray is None
    with pytest.raises(ValueError, match="gray"):
        sim.step_rows(states, 0, no_gray, scn)


def test_alternating_scenarios_are_prepared_once(monkeypatch):
    """A caller that alternates two rows' scenarios tick by tick (as a sweep
    over buckets does) prepares each once: one host copy of each schedule,
    and the fault masks uploaded only when a scenario's own active set
    changes.  The ticks equal those of a simulator that keeps one
    scenario's tables and so rebuilds them at every switch."""
    tsims = port_rows()
    sim = tsims[0]
    scns = [stack_scenarios([s.scn for s in tsims]),
            stack_scenarios([tsims[i].scn for i in (2, 0, 1)])]
    n = 120
    made = []
    make = tengine.Simulator._make_tables
    monkeypatch.setattr(tengine.Simulator, "_make_tables",
                        lambda self, scn: made.append(id(scn)) or make(self, scn))

    def alternate(fleet):
        states = fleet.init_states()
        draws = fleet.sim.tick_draws(fleet.base_keys(), 0, n, scns[0])
        uploads = [[], []]  # per scenario: its fault masks at each of its ticks
        for t in range(n):
            states, _ = fleet.sim.step_rows(states, t, draws.row(t), scns[t % 2])
            uploads[t % 2].append(fleet.sim._tables(scns[t % 2], 3).faults)
        return states, uploads

    fleet = FleetRunner(sim.cfg, sim.wl, sim.lb, failures=sim.failures,
                        watch_queues=sim.watch.numpy(), seeds=SEEDS, device="cpu")
    states, uploads = alternate(fleet)
    assert made == [id(scns[0]), id(scns[1])]
    for k in (0, 1):  # a new upload exactly where the scenario's active set changes
        f = [x.numpy() for x in (scns[k].f_start, scns[k].f_end)]
        acts = [((t >= f[0]) & (t < f[1])).tobytes() for t in range(k, n, 2)]
        changes = sum(a != b for a, b in zip(acts, acts[1:]))
        fresh = sum(a is not b for a, b in zip(uploads[k], uploads[k][1:]))
        assert fresh == changes > 0, (k, fresh, changes)

    made.clear()
    monkeypatch.setattr(tengine, "SCN_TABLES", 1)
    rebuilt = FleetRunner(sim.cfg, sim.wl, sim.lb, failures=sim.failures,
                          watch_queues=sim.watch.numpy(), seeds=SEEDS, device="cpu")
    again, _ = alternate(rebuilt)
    assert len(made) == n
    for i in range(len(SEEDS)):
        assert_states_equal(interop.sim_state_to_numpy(fleet.state_at(states, i)),
                            interop.sim_state_to_numpy(rebuilt.state_at(again, i)), f"row {i}")
