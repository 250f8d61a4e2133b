"""The port's simulator against the JAX reference: topology and hashing,
workload and failure builders, the congestion-control float sites, and the
engine tick by tick — every SimState leaf equal after every tick, for ECMP,
OPS and REPS under a link failure, on the CPU (where every kernel site runs
the kernel's plain version).  The rest of the LB zoo is held the same way
by tests/test_torch_lb_engine*.py."""
import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arcane_paper as jpresets
from repro.core import make_lb as j_make_lb
from repro.netsim import engine as jengine
from repro.netsim import failures as jfail
from repro.netsim import metrics as jmetrics
from repro.netsim import topology as jtopo
from repro.netsim import workloads as jwl
from repro_torch.configs import arcane_paper as tpresets
from repro_torch.core import make_lb as t_make_lb
from repro_torch.netsim import engine as tengine
from repro_torch.netsim import failures as tfail
from repro_torch.netsim import interop, metrics as tmetrics
from repro_torch.netsim import topology as ttopo
from repro_torch.netsim import workloads as twl

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

REPO = Path(__file__).resolve().parents[1]


def jax_lb_to_numpy(prefix: str, x, out: dict) -> None:
    """A JAX load-balancer state flattened by path, as ``interop`` names the
    port's: dataclass fields by name, tuple elements by index."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            jax_lb_to_numpy(f"{prefix}.{f.name}", getattr(x, f.name), out)
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            jax_lb_to_numpy(f"{prefix}.{i}", v, out)
    else:
        out[prefix] = np.asarray(x)


def jax_state_to_numpy(st) -> dict:
    """A JAX SimState as the port's interop dict (same names, shapes, dtypes)."""
    out = {}
    for name in st._fields:
        leaf = getattr(st, name)
        if name == "lb_state":
            jax_lb_to_numpy("lb_state", leaf, out)
        else:
            out[name] = np.asarray(leaf)
    return out


def assert_states_equal(a: dict, b: dict, where: str) -> None:
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = a[k], b[k]
        assert x.shape == y.shape and x.dtype == y.dtype, (where, k, x.shape, y.shape, x.dtype, y.dtype)
        if x.tobytes() != y.tobytes():  # bitwise, floats included
            bad = np.argwhere(x != y)[:5].tolist()
            raise AssertionError(f"{where}: leaf {k} differs at {bad}")


# ---------------------------------------------------------------------------
def test_presets_match_reference():
    for name in ("FATTREE_128", "FATTREE_1024", "FATTREE_32_CI", "FATTREE_64_CI",
                 "FATTREE_128_3T", "FATTREE_128_OVERSUB4"):
        j, t = getattr(jpresets, name), getattr(tpresets, name)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        for backend in ("arrivals_backend", "kernels_backend"):
            jd.pop(backend), td.pop(backend)
        assert jd == td, name
        assert (j.kmin, j.kmax, j.n_tors) == (t.kmin, t.kmax, t.n_tors)


@pytest.mark.parametrize("tiers,adaptive", [(2, False), (2, True), (3, False), (3, True)])
def test_next_queue_matches_reference(tiers, adaptive):
    kw = dict(tiers=3, tors_per_pod=2, aggs_per_pod=4, agg_uplinks=4) if tiers == 3 else {}
    jcfg = jpresets.FATTREE_128.replace(**kw)
    tcfg = tpresets.FATTREE_128.replace(**kw)
    jt, tt = jtopo.Topology.build(jcfg), ttopo.Topology.build(tcfg)
    assert (jt.n_queues, jt.t0_down_base, jt.diameter) == (tt.n_queues, tt.t0_down_base, tt.diameter)
    rs = np.random.RandomState(tiers)
    K = 2000
    args = [
        rs.rand(K) < 0.3,
        rs.randint(0, jt.n_queues, size=K).astype(np.int32),
        rs.randint(0, 4096, size=K).astype(np.int32),
        rs.randint(0, 65536, size=K).astype(np.int32),
        rs.randint(0, 128, size=K).astype(np.int32),
        rs.randint(0, 128, size=K).astype(np.int32),
        rs.randint(0, 90, size=jt.n_queues).astype(np.int32),
    ]
    want = np.asarray(jt.next_queue(*[jnp.asarray(a) for a in args], adaptive=adaptive))
    got = tt.next_queue(*[torch.as_tensor(a) for a in args], adaptive=adaptive).numpy()
    np.testing.assert_array_equal(got, want)


def test_ecmp_hash_matches_reference():
    rs = np.random.RandomState(0)
    flow = rs.randint(-2**31, 2**31 - 1, size=5000, dtype=np.int64).astype(np.int32)
    ev = rs.randint(0, 65536, size=5000).astype(np.int32)
    salt = rs.randint(0, 10000, size=5000).astype(np.int32)
    for nports in (2, 7, 16, 64):
        want = np.asarray(jtopo.ecmp_hash(flow, ev, salt, nports))
        got = ttopo.ecmp_hash(torch.as_tensor(flow), torch.as_tensor(ev), torch.as_tensor(salt), nports)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ttopo.mix32(torch.as_tensor(flow)).numpy().astype(np.uint32), np.asarray(jtopo.mix32(flow)))
    for f, e, s in zip(flow[:50].tolist(), ev[:50].tolist(), salt[:50].tolist()):
        assert ttopo.ecmp_hash_np(f, e, s, 13) == jtopo.ecmp_hash_np(f, e, s, 13)


def test_ecmp_hash_per_lane_nports_matches_reference():
    """``nports`` as one port count per lane (a generated fabric's up-degree
    per arrival, ``TableTopology``'s ``maximum(deg, 1)``): the port's
    ``ecmp_hash`` equals the reference's, on the example that the port once
    refused, on (B, K) lanes with counts 1..16 and with counts broadcast
    over the rows; the scalar form is unchanged; a count < 1 raises."""
    f = np.arange(8, dtype=np.int32)
    args = (f, 7 * f, f % 3, np.arange(1, 9, dtype=np.int32))
    got = ttopo.ecmp_hash(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 2, 3, 1, 2, 6, 2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtopo.ecmp_hash(*args)))
    np.testing.assert_array_equal(
        ttopo.ecmp_hash(*(torch.as_tensor(a) for a in args[:3]), 5).numpy(),
        [0, 4, 0, 4, 1, 4, 3, 3])
    rs = np.random.RandomState(16)
    flow = rs.randint(-2**31, 2**31 - 1, size=(3, 700), dtype=np.int64).astype(np.int32)
    ev = rs.randint(0, 65536, size=(3, 700)).astype(np.int32)
    salt = (2**31 - 1 - rs.randint(0, 9000, size=(3, 700))).astype(np.int32)
    for nports in (rs.randint(1, 17, size=(3, 700)), rs.randint(1, 17, size=700),
                   np.ones((3, 700)), np.full(700, 2**20)):
        nports = nports.astype(np.int32)
        got = ttopo.ecmp_hash(*(torch.as_tensor(a) for a in (flow, ev, salt, nports)))
        assert got.shape == (3, 700) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jtopo.ecmp_hash(flow, ev, salt, nports)))
        assert (got.numpy() < nports).all()
    with pytest.raises(ValueError, match="every lane"):
        ttopo.ecmp_hash(*(torch.as_tensor(a) for a in args[:3]),
                        torch.as_tensor(np.arange(8, dtype=np.int32)))
    with pytest.raises(TypeError, match="integer"):
        ttopo.ecmp_hash(*(torch.as_tensor(a) for a in args[:3]), torch.ones(8))


def test_workload_builders_match_reference():
    pairs = [
        ("permutation", (128, 4096), dict(seed=3)),
        ("incast", (32, 16, 48), {}),
        ("tornado", (64, 100), {}),
        ("websearch_trace", (16, 0.4, 3000), dict(seed=2, max_pkts=512)),
        ("ring_allreduce", (8, 64), {}),
        ("butterfly_allreduce", (16, 64), {}),
        ("alltoall", (8, 12), dict(window=3, seed=1)),
    ]
    for name, args, kw in pairs:
        j, t = getattr(jwl, name)(*args, **kw), getattr(twl, name)(*args, **kw)
        for f in ("src", "dst", "msg_pkts", "start", "dep"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f"{name}.{f}")
        assert t.name == j.name
    (jw, jbg), (tw, tbg) = (m.permutation_with_background(32, 40, 0.25, seed=4) for m in (jwl, twl))
    np.testing.assert_array_equal(tbg, jbg)
    np.testing.assert_array_equal(tw.dst, jw.dst)


def test_failure_builders_match_reference():
    jcfg, tcfg = jpresets.FATTREE_32_CI, tpresets.FATTREE_32_CI
    calls = [
        ("link_down", lambda m, c: m.link_down([3, 5], 10, 90)),
        ("link_degraded", lambda m, c: m.link_degraded([1], 0, m.FOREVER)),
        ("gray_loss", lambda m, c: m.gray_loss([2, 4], 5, 50, 0.25)),
        ("link_flapping", lambda m, c: m.link_flapping([6], 0, 400, 100, 30)),
        ("switch_down", lambda m, c: m.switch_down(c, 1, 40)),
        ("switch_degraded", lambda m, c: m.switch_degraded(c, 2, 40, 300)),
        ("spine_degraded", lambda m, c: m.spine_degraded(c, 3, 10)),
        ("spine_down", lambda m, c: m.spine_down(c, 5, 100, 200)),
        ("random_degraded_uplinks", lambda m, c: m.random_degraded_uplinks(c, 0.2, seed=3)),
        ("random_down_uplinks", lambda m, c: m.random_down_uplinks(c, 0.1, 50, 500, seed=7)),
        ("incremental_uplink_failures", lambda m, c: m.incremental_uplink_failures(c, 0, 3, 100, 50)),
    ]
    for name, call in calls:
        j, t = call(jfail, jcfg), call(tfail, tcfg)
        for f in ("queue", "start", "end", "kind", "param"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f"{name}.{f}")
    base_j = jengine.FailureSchedule.concat(jfail.link_down([1], 0, 100), jfail.link_degraded([2], 0, 50))
    base_t = tengine.FailureSchedule.concat(tfail.link_down([1], 0, 100), tfail.link_degraded([2], 0, 50))
    dj, dt = jfail.link_down([2], 60, 80), tfail.link_down([2], 60, 80)
    mj, mt = base_j.merge(dj, at_tick=60, n_queues=96), base_t.merge(dt, at_tick=60, n_queues=96)
    for f in ("queue", "start", "end", "kind", "param"):
        np.testing.assert_array_equal(getattr(mt.pad_to(7), f), getattr(mj.pad_to(7), f))
        np.testing.assert_array_equal(getattr(tfail.truncate_dead(mt, 70), f),
                                      getattr(jfail.truncate_dead(mj, 70), f))
    with pytest.raises(ValueError, match="resurrect"):
        base_t.merge(tfail.link_down([1], 50, 150), at_tick=50)
    with pytest.raises(ValueError, match="unknown kind"):
        tengine.FailureSchedule(np.array([1]), np.array([0]), np.array([5]), np.array([9])).validate()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cc", ["dctcp", "delay", "eqds"])
def test_cc_float_sites_round_like_xla(cc):
    """The CC update on the values the engine produces and on edge values
    (tiny and subnormal alpha, large/small cwnd): bit-equal to the jitted
    reference, which contracts (1-g)*alpha + g*ecn and cwnd - beta*x into
    FMAs and flushes subnormals."""
    kw = dict(cc=cc, delay_beta=0.3, delay_target_ticks=48) if cc == "delay" else dict(cc=cc)
    if cc == "dctcp":
        kw["dctcp_g"] = 0.1
    jcfg, tcfg = jpresets.FATTREE_128.replace(**kw), tpresets.FATTREE_128.replace(**kw)
    rs = np.random.RandomState(5)
    n = 1 << 16
    alpha = rs.rand(n).astype(np.float32)
    alpha[: n // 8] *= np.float32(2.0) ** rs.randint(-140, -100, size=n // 8)  # tiny and subnormal
    alpha[n // 8: n // 4] = (np.float32(1 / 16) * np.float32(15 / 16) ** rs.randint(0, 1500, size=n // 8))
    cwnd = (rs.rand(n) * 170 + 0.5).astype(np.float32)
    mask = rs.rand(n) < 0.9
    ecn = rs.rand(n) < 0.5
    rtt = rs.randint(0, 400, size=n).astype(np.int32)
    stub = types.SimpleNamespace(cfg=jcfg)
    jf = jax.jit(lambda *a: jengine.Simulator._cc_on_ack(stub, *a))
    want = [np.asarray(x) for x in jf(cwnd, alpha, mask, ecn, rtt)]
    tstub = types.SimpleNamespace(cfg=tcfg, _ones_nc=torch.ones(n))
    got = tengine.Simulator._cc_on_ack(
        tstub, *[torch.as_tensor(a) for a in (cwnd, alpha, mask, ecn, rtt)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32))


# ---------------------------------------------------------------------------
TICKS = 470
FAIL = (30, 300)


def _scenario(lbn: str):
    cfg = jpresets.FATTREE_32_CI
    ups = [int(q) for q in jtopo.Topology.build(cfg).t0_up_queues(0)[:2]]
    kw = dict(evs_size=cfg.evs_size)
    if lbn == "reps":
        kw["freezing_timeout"] = 200
    return ups, kw


def run_tick_by_tick(lbn: str, kw: dict, ticks: int, workload, failures_of, cfg_kw=None,
                     seed: int = 1):
    """Step the jitted JAX tick and the port's CPU tick side by side from the
    same scenario; after every tick, every SimState leaf and the tick trace
    must be equal.  Returns both simulators and final states."""
    cfg_kw = cfg_kw or {}
    jsim = jengine.Simulator(
        jpresets.FATTREE_32_CI.replace(arrivals_backend="jnp", kernels_backend="jnp", **cfg_kw),
        workload(jwl), j_make_lb(lbn, **kw), failures=failures_of(jfail), seed=seed,
    )
    tsim = tengine.Simulator(
        tpresets.FATTREE_32_CI.replace(**cfg_kw), workload(twl), t_make_lb(lbn, **kw),
        failures=failures_of(tfail), seed=seed, device="cpu",
    )
    assert (tsim.NP, tsim.MAX_ARR, tsim.MAX_EV, tsim.MAX_FREE, tsim.CPH, tsim.MSG) == (
        jsim.NP, jsim.MAX_ARR, jsim.MAX_EV, jsim.MAX_FREE, jsim.CPH, jsim.MSG)
    tick = jax.jit(jsim.tick_fn)
    js, ts = jsim.init_state(), tsim.init_state()
    draws = tsim.tick_draws(tsim.base_key, 0, ticks)
    for t in range(ticks):
        js, jtr = tick(js, jnp.int32(t))
        ts, ttr = tsim.tick_fn(ts, t, draws.row(t))
        assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), f"tick {t}")
        for a, b in zip(jtr, ttr):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert dataclasses.asdict(tmetrics.summarize(tsim, ts)) == dataclasses.asdict(
        jmetrics.summarize(jsim, js))
    return jsim, js, tsim, ts


@pytest.mark.parametrize("lbn", ["ecmp", "ops", "reps"])
def test_engine_tick_by_tick_matches_reference(lbn):
    """FATTREE_32_CI, a permutation of 48-packet messages, two ToR-0 uplinks
    down over ticks 30-300: after every tick, every SimState leaf and the
    tick trace equal the jitted JAX tick (the port on the CPU, through the
    kernels' plain versions); the final RunSummary is equal too."""
    ups, kw = _scenario(lbn)
    _, js, _, _ = run_tick_by_tick(
        lbn, kw, TICKS, lambda m: m.permutation(32, 48, seed=3),
        lambda m: m.link_down(ups, *FAIL))
    stats = np.asarray(js.s_stats)
    done_ticks = np.asarray(js.c_done_tick)
    assert stats[jengine.ST_DROPS_FAIL] > 0 and stats[jengine.ST_TIMEOUTS] > 0
    assert (done_ticks >= 0).sum() > 16  # c_done_tick exercised
    if lbn == "reps":
        assert (np.asarray(js.lb_state.exit_freezing) > 0).any()  # REPS froze


def test_engine_off_main_path_options_match_reference():
    """The branches the main path leaves off, tick by tick against JAX:
    trimming (NACKs), 2:1 ACK coalescing, the delay CC, and degraded and
    gray-loss links beside a down link, under an incast."""
    cfg_kw = dict(trimming=True, ack_coalesce=2, cc="delay", delay_beta=0.3)
    jcfg = jpresets.FATTREE_32_CI.replace(arrivals_backend="jnp", kernels_backend="jnp", **cfg_kw)
    tcfg = tpresets.FATTREE_32_CI.replace(**cfg_kw)
    ups = [int(q) for q in jtopo.Topology.build(jcfg).t0_up_queues(1)[:3]]

    def faults(m, E):
        return E.FailureSchedule.concat(m.link_down([ups[0]], 20, 120),
                                        m.link_degraded([ups[1]], 0, 200),
                                        m.gray_loss([ups[2]], 10, 150, 0.3))

    jsim = jengine.Simulator(jcfg, jwl.incast(32, 20, 24), j_make_lb("ops", evs_size=256),
                             failures=faults(jfail, jengine), seed=2)
    tsim = tengine.Simulator(tcfg, twl.incast(32, 20, 24), t_make_lb("ops", evs_size=256),
                             failures=faults(tfail, tengine), seed=2, device="cpu")
    tick = jax.jit(jsim.tick_fn)
    js, ts = jsim.init_state(), tsim.init_state()
    for t in range(200):
        js, _ = tick(js, jnp.int32(t))
        ts, _ = tsim.tick_fn(ts, t)
        assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), f"tick {t}")
    stats = np.asarray(js.s_stats)
    assert stats[jengine.ST_DROPS_CONG] > 0 and stats[jengine.ST_DROPS_FAIL] > 0


def test_port_resumes_from_a_jax_state():
    """interop: start the port from the JAX state at tick t and step once."""
    ups, kw = _scenario("reps")
    jsim = jengine.Simulator(jpresets.FATTREE_32_CI.replace(arrivals_backend="jnp", kernels_backend="jnp"),
                             jwl.permutation(32, 48, seed=5), j_make_lb("reps", **kw),
                             failures=jfail.link_down(ups, *FAIL))
    tsim = tengine.Simulator(tpresets.FATTREE_32_CI, twl.permutation(32, 48, seed=5),
                             t_make_lb("reps", **kw), failures=tfail.link_down(ups, *FAIL),
                             device="cpu")
    js, _ = jsim.run(130)
    ts = interop.sim_state_from_numpy(jax_state_to_numpy(js), device="cpu")
    assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), "round trip")
    js2, _ = jax.jit(jsim.tick_fn)(js, jnp.int32(130))
    ts2, _ = tsim.tick_fn(ts, 130)
    assert_states_equal(jax_state_to_numpy(js2), interop.sim_state_to_numpy(ts2), "tick 130")


def test_entry_points_refuse_what_is_not_ported():
    wl = twl.permutation(32, 8, seed=0)
    lb = t_make_lb("ops", evs_size=256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.Simulator(tpresets.FATTREE_32_CI, wl, lb)
    # scale mode, generated fabrics, the flight recorder's events and the
    # conn axis are ported (tests/test_torch_conn_axis.py); a conn axis
    # names the ranks it spans (a mesh dimension or a process group), not
    # the reference's mesh-axis string, and a state not cut to its block
    # is refused
    sim = tengine.Simulator(tpresets.FATTREE_32_CI.replace(conn_sharding=True), wl, lb,
                            device="cpu")
    with pytest.raises(TypeError, match="not a mesh-axis name"):
        sim.step_scenario(sim.init_state(), 0, sim.base_key, conn_axis="conns")
    with pytest.raises(ValueError, match="this rank's block"):
        sim.step_scenario(sim.init_state(), 0, sim.base_key,
                          conn_axis=tengine.ConnShard(group=None, rank=0, size=2))
    _, _, events = sim.step_scenario(sim.init_state(), 0, sim.base_key, emit_events=True)
    assert events.lb.shape == (8,) and events.fail_start.shape == ()
    assert isinstance(ttopo.Topology.build(tpresets.FATTREE_32_CI.replace(
        fabric="mesh:tors=4,hosts=8,planes=2")), ttopo.TableTopology)
    with pytest.raises(ValueError, match="unknown load balancer"):
        t_make_lb("no_such_lb")
    with pytest.raises(ValueError, match="only 'auto'"):
        tpresets.FATTREE_32_CI.replace(kernels_backend="torch")


def test_port_imports_neither_jax_nor_the_reference():
    """Importing every repro_torch module (and chip_smoke.py) in a fresh
    interpreter leaves jax and repro out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
