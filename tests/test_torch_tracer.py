"""The port's flight recorder (repro_torch.netsim.tracer, the engine's
TickEvents / step_events, LoadBalancer.trace and the traced reps_tick)
against the reference's on the CPU, bit for bit (tolerance 0).

Every load balancer runs one scenario (FATTREE_32_CI, a permutation, two
ToR-0 uplinks down from tick 30) tick by tick in both packages: each
tick's TickEvents equal JAX's ``step_events``, the ring carry equals JAX's
after every tick, and the final state equals the port's untraced run.  The
rest of the zoo is in tests/test_torch_tracer_zoo.py, the sweep's
``trace=`` in tests/test_torch_tracer_sweep.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.netsim.mixed  # noqa: F401  (registers "mixed")
import repro_torch.netsim.mixed  # noqa: F401
from repro.configs import arcane_paper as jpresets
from repro.core import load_balancers as jlbs
from repro.core import make_lb as j_make_lb
from repro.core import reps as jreps
from repro.netsim import engine as jengine
from repro.netsim import failures as jfail
from repro.netsim import topology as jtopo
from repro.netsim import tracer as jtracer
from repro.netsim import workloads as jwl
from repro_torch import rng
from repro_torch.configs import arcane_paper as tpresets
from repro_torch.core import load_balancers as tlbs
from repro_torch.core import make_lb as t_make_lb
from repro_torch.kernels import ref as kref
from repro_torch.netsim import engine as tengine
from repro_torch.netsim import failures as tfail
from repro_torch.netsim import interop
from repro_torch.netsim import tracer as ttracer
from repro_torch.netsim import workloads as twl
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

CFG_J, CFG_T = jpresets.FATTREE_32_CI, tpresets.FATTREE_32_CI
UPS = [int(q) for q in jtopo.Topology.build(CFG_J).t0_up_queues(0)[:2]]
TICKS = 460
SPEC = dict(ring=4096, marker_every=128)


def _lb(m_make, lbn, kw):
    if lbn.startswith("switch:"):
        lbs = m_make.__module__.startswith("repro_torch") and tlbs or jlbs
        names = lbn.split(":")[1].split("+")
        return lbs.SwitchLB([m_make(n, evs_size=CFG_J.evs_size) for n in names])
    return m_make(lbn, evs_size=CFG_J.evs_size, **kw)


def sims(lbn, kw, workload=lambda m: m.permutation(32, 64, seed=3),
         failures_of=lambda m: m.link_down(UPS, 30, 2**30)):
    jsim = jengine.Simulator(CFG_J, workload(jwl), _lb(j_make_lb, lbn, kw),
                             failures=failures_of(jfail))
    tsim = tengine.Simulator(CFG_T, workload(twl), _lb(t_make_lb, lbn, kw),
                             failures=failures_of(tfail), device="cpu")
    return jsim, tsim


def run_events_tick_by_tick(lbn, kw, ticks=TICKS, **scenario):
    """Both packages' traced ticks side by side: TickEvents and the ring
    carry equal after every tick; the final states equal JAX's and the
    port's untraced run's.  Returns the port's simulator, state and ring."""
    jsim, tsim = sims(lbn, kw, **scenario)
    jprog = jtracer.TraceSpec(**SPEC).build(jsim, ticks)
    tprog = ttracer.TraceSpec(**SPEC).build(tsim, ticks)
    jstep = jax.jit(lambda s, t: jsim.step_events(s, t, jsim.base_key, jsim.scn))
    jupd = jax.jit(jprog.update)
    js, jtrc = jsim.init_state(), jprog.init()
    states = tengine.add_rows(tsim.init_state())
    ttrc = tprog.init_rows(1)
    draws = tsim.tick_draws(tsim.base_key[None], 0, ticks)
    seen = np.zeros(9, np.int64)
    for t in range(ticks):
        js, jprobe, jev = jstep(js, jnp.int32(t))
        jtrc = jupd(jtrc, jprobe, jev)
        states, probe, ev = tsim.step_events_rows(states, t, draws.row(t))
        tprog.update(ttrc, probe, ev)
        np.testing.assert_array_equal(ev.lb[0].numpy(), np.asarray(jev.lb), err_msg=f"tick {t}")
        assert int(ev.fail_start[0]) == int(jev.fail_start), t
        np.testing.assert_array_equal(ttrc[0].numpy(), np.asarray(jtrc), err_msg=f"ring, tick {t}")
        seen[:8] += np.asarray(jev.lb)
        seen[8] += int(jev.fail_start)
    final = tengine.drop_rows(states)
    assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(final), lbn)
    plain, _ = tsim.run(ticks)
    assert_states_equal(interop.sim_state_to_numpy(plain), interop.sim_state_to_numpy(final),
                        f"{lbn}: traced vs untraced")
    assert seen[8] == 2  # the two uplinks open at tick 30
    return tsim, final, ttrc[0], seen


LBS = [("reps", {"freezing_timeout": 300}), ("ops", {}), ("plb", {})]


def check_lb(lbn, kw, ticks=TICKS):
    """``run_events_tick_by_tick`` and what the LB's events must show."""
    _, _, trc, seen = run_events_tick_by_tick(lbn, kw, ticks)
    assert int(trc[0]) > 0
    if lbn.split(":")[-1].startswith("reps") or lbn == "mixed":
        kinds = (tlbs.TR_EV_HIT, tlbs.TR_EV_MISS, tlbs.TR_EV_FREEZE)
        assert all(seen[k] > 0 for k in kinds), seen  # hits, misses and a freeze
    if lbn in ("plb", "switch:plb+reps", "mptcp", "prime", "seqbalance", "flowlet_table"):
        assert seen[tlbs.TR_REPATH_RTO] > 0, seen
    if lbn in ("ecmp", "ops", "mprdma", "bitmap", "adaptive_roce", "switch:ops+ecmp"):
        assert not seen[:8].any(), seen  # these report no decision
    return seen


@pytest.mark.parametrize("lbn,kw", LBS, ids=[n for n, _ in LBS])
def test_tick_events_and_ring_match_reference(lbn, kw):
    check_lb(lbn, kw)


def test_serial_ring_matches_reference_run_serial():
    """``tracer.run_serial`` in both packages (JAX's as one scan)."""
    jsim, tsim = sims("reps", {"freezing_timeout": 300})
    _, jtrc = jtracer.run_serial(jsim, TICKS, jtracer.TraceSpec(**SPEC))
    state, ttrc = ttracer.run_serial(tsim, TICKS, ttracer.TraceSpec(**SPEC))
    np.testing.assert_array_equal(ttrc.numpy(), np.asarray(jtrc))
    plain, _ = tsim.run(TICKS)
    assert_states_equal(interop.sim_state_to_numpy(plain), interop.sim_state_to_numpy(state), "")


def test_events_are_bit_invisible_on_state_and_probe():
    """``step_events_rows`` returns the state and the probe of
    ``step_probe_rows``, bit for bit, over rows with their own seeds."""
    _, tsim = sims("reps", {"freezing_timeout": 300})
    keys = torch.stack([rng.PRNGKey(s, "cpu") for s in (0, 4, 9)])
    a = b = tengine.tree_map(lambda *x: torch.stack(x), *(tsim.init_state(k) for k in keys))
    draws = tsim.tick_draws(keys, 0, 220)
    for t in range(220):
        a, pa = tsim.step_probe_rows(a, t, draws.row(t))
        b, pb, ev = tsim.step_events_rows(b, t, draws.row(t))
        assert ev.lb.shape == (3, tlbs.N_TRACE_KINDS) and ev.fail_start.shape == (3,)
        assert pa.now == pb.now
        for x, y in zip(pa[1:], pb[1:]):
            assert torch.equal(x, y), t
    la, lb_ = _leaves(a), _leaves(b)
    assert len(la) == len(lb_) and all(torch.equal(x, y) for x, y in zip(la, lb_))


def _leaves(x):
    out = []
    tengine.tree_map(lambda t: out.append(t), x)
    return out


# --- the traced reps_tick's plain version against the reference's trace ---
def _rand_reps_state(rs, n, buf=8):
    return dict(
        buf_ev=rs.randint(0, 1000, (n, buf)).astype(np.int32),
        buf_valid=rs.rand(n, buf) < 0.5,
        head=rs.randint(0, buf, n).astype(np.int32),
        num_valid=rs.randint(0, buf + 1, n).astype(np.int32),
        explore_counter=rs.randint(0, 3, n).astype(np.int32) * (rs.rand(n) < 0.4),
        is_freezing=rs.rand(n) < 0.3,
        exit_freezing=rs.randint(0, 200, n).astype(np.int32),
        n_cached=rs.randint(0, 3, n).astype(np.int32),
    )


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("freezing", [True, False])
def test_traced_reps_tick_counts_match_reference_trace(rows, freezing):
    """``reps_tick_ref(..., trace_rows=B)`` counts, per row, what the
    reference's ``RepsLB.trace`` diffs around on_timeout and choose_ev
    count for that row's connections; the state outputs equal the untraced
    call's."""
    rs = np.random.RandomState(5 + rows)
    n = 64 * rows
    st = _rand_reps_state(rs, n)
    st["explore_counter"] = st["explore_counter"].astype(np.int32)
    st["num_valid"] = np.minimum(st["num_valid"], st["buf_valid"].sum(1)).astype(np.int32)
    jlb = jlbs.RepsLB(evs_size=1000, freezing_timeout=50, enable_freezing=freezing)
    acks = [(rs.rand(n) < 0.5, rs.randint(0, 1000, n).astype(np.int32), rs.rand(n) < 0.2)
            for _ in range(2)]
    tmask, smask = rs.rand(n) < 0.3, rs.rand(n) < 0.7
    rand_ev = rs.randint(0, 1000, n).astype(np.int32)
    now = 120
    # reference: the engine's call sites with the trace diffs
    js = jreps.REPSState(**{k: jnp.asarray(v) for k, v in st.items()})
    for m, e, c in acks:
        js = jlb.on_ack(js, jnp.asarray(m), jnp.asarray(e), jnp.asarray(c), now, None)
    want = np.zeros((rows, 8), np.int64)
    for r in range(rows):
        sl = slice(64 * r, 64 * (r + 1))
        sub = lambda s: jax.tree_util.tree_map(lambda x: x[sl], s)
        a = sub(js)
        b = jlb.on_timeout(a, jnp.asarray(tmask[sl]), now, None)
        want[r] += np.asarray(jlb.trace("timeout", a, b, jnp.asarray(tmask[sl])))
        cfg = jreps.REPSConfig(evs_size=1000, freezing_timeout=50)
        # the state diffs do not depend on the explored EVs' values
        _, c = jreps.choose_ev(cfg, b, jnp.asarray(smask[sl]), jax.random.PRNGKey(0))
        want[r] += np.asarray(jlb.trace("choose", b, c, jnp.asarray(smask[sl])))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    args = (t(st["buf_ev"]), t(st["buf_valid"]), t(st["head"]), t(st["num_valid"]),
            t(st["explore_counter"]), t(st["is_freezing"]), t(st["exit_freezing"]),
            t(st["n_cached"]), [t(m) for m, _, _ in acks], [t(e) for _, e, _ in acks],
            [t(c) for _, _, c in acks], t(tmask) if freezing else None, t(smask), t(rand_ev),
            now, 32, 50)
    plain = kref.reps_tick_ref(*args)
    traced = kref.reps_tick_ref(*args, trace_rows=rows)
    assert len(traced) == len(plain) + 1
    for x, y in zip(plain, traced):
        assert torch.equal(x, y)
    counts = traced[-1]
    assert counts.shape == (rows, 8) and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want)
    assert want[:, :3].sum() == int(smask.sum())  # every send is a hit, miss or recycle
    if not freezing:
        assert (want[:, 3] == 0).all()


# --- ring mechanics ---------------------------------------------------------
def test_ring_wraparound_reports_lost_and_incremental_decode():
    """A ring smaller than the event count overwrites oldest first and
    reports the overwritten count; an incremental drain concatenates to the
    full history; both equal JAX's decode."""
    jsim, tsim = sims("reps", {})
    big, small = ttracer.TraceSpec(ring=4096), ttracer.TraceSpec(ring=16)
    _, trc_big = ttracer.run_serial(tsim, 300, big)
    _, trc_small = ttracer.run_serial(tsim, 300, small)
    _, jtrc_small = jtracer.run_serial(jsim, 300, jtracer.TraceSpec(ring=16))
    np.testing.assert_array_equal(trc_small.numpy(), np.asarray(jtrc_small))
    full = big.build(tsim, 300).decode_row(trc_big.numpy())
    tail = small.build(tsim, 300).decode_row(trc_small.numpy())
    n = full["cursor"]
    assert n > 16
    assert tail["cursor"] == n and tail["lost"] == n - 16
    np.testing.assert_array_equal(tail["tick"], full["tick"][-16:])
    np.testing.assert_array_equal(tail["code"], full["code"][-16:])
    jtail = jtracer.TraceSpec(ring=16).build(jsim, 300).decode_row(np.asarray(jtrc_small), since=5)
    ttail = small.build(tsim, 300).decode_row(trc_small.numpy(), since=5)
    for k in ("seq", "tick", "code", "value"):
        np.testing.assert_array_equal(ttail[k], jtail[k])
    assert ttail["lost"] == jtail["lost"] and ttail["cursor"] == jtail["cursor"]
    prog = big.build(tsim, 300)
    cuts = [0, 3, 17, n // 2, n]
    parts = [prog.decode_row(trc_big.numpy(), since=c) for c in cuts[:-1]]
    got = np.concatenate([p["tick"][: b - a] for p, (a, b) in zip(parts, zip(cuts, cuts[1:]))])
    np.testing.assert_array_equal(got, full["tick"])
    assert all(p["lost"] == 0 for p in parts)


def test_quiescent_ticks_leave_the_ring_unchanged():
    """Once the workload drains no event pushes: a 400-tick ring equals
    the same scenario's ring after 1200 ticks, bit for bit."""
    _, tsim = sims("ops", {}, workload=lambda m: m.permutation(32, 16, seed=1),
                   failures_of=lambda m: None)
    spec = ttracer.TraceSpec(**SPEC)
    _, short = ttracer.run_serial(tsim, 400, spec)
    _, long = ttracer.run_serial(tsim, 1200, spec)
    assert int(short[0]) > 0
    assert torch.equal(short, long)


def test_spec_validation_and_layout():
    with pytest.raises(ValueError, match="ring"):
        ttracer.TraceSpec(ring=4).build(None, 100)
    with pytest.raises(ValueError, match="marker_every"):
        ttracer.TraceSpec(marker_every=0).build(None, 100)
    prog = ttracer.TracerProgram(ttracer.TraceSpec(ring=32), None, 100)
    assert prog.size == 3 + 3 * 32 and prog.nbytes == prog.size * 4
    flat = prog.init().numpy()
    jflat = np.asarray(jtracer.TracerProgram(jtracer.TraceSpec(ring=32), None, 100).init())
    np.testing.assert_array_equal(flat, jflat)
    d = prog.decode_row(flat)
    assert d["cursor"] == 0 and len(d["seq"]) == 0
    assert d["first_drop_tick"] == -1 and d["first_redeliver_tick"] == -1
    assert ttracer.CODE_NAMES == jtracer.CODE_NAMES
    assert ttracer.TraceSpec() == ttracer.TraceSpec(ring=256, marker_every=256)
    for k in ("TR_EV_HIT", "TR_EV_MISS", "TR_EV_RECYCLE", "TR_EV_FREEZE", "TR_REPATH_ACK_ECN",
              "TR_REPATH_RTO", "TR_REPATH_FLOWLET", "TR_REPATH_EPOCH", "N_TRACE_KINDS"):
        assert getattr(tlbs, k) == getattr(jlbs, k), k
