"""The port's load-balancer zoo against the JAX classes, call by call: every
registry LB, MixedLB and a SwitchLB over all endpoint variants, stepped
through ``init_state``, ``draw`` + ``choose_ev``, ``on_ack`` (two feedback
rounds) and ``on_timeout`` on the same keys and the same event masks,
with every state leaf and every chosen EV equal (tolerance 0), at 256 and
at 65536 EVs; and ``step``, the engine's one call per tick, against those
calls one by one for every LB, MixedLB and SwitchLB.  Then the unit tests of tests/test_lb_arena.py, mirrored on
the port: keyed re-path draws, PLB's idle-gap rollover, SwitchLB's
evs_size check, and the Prime, SeqBalance and flowlet-table behaviours.
``test_fleet_seeds_decorrelated_under_congestion`` needs a fleet and is
mirrored with the port's ``FleetRunner`` in tests/test_torch_fleet_arena.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.netsim  # noqa: F401  (registers the reference's "mixed")
from repro.core import load_balancers as jlbs
from repro_torch import rng
from repro_torch.core import load_balancers as tlbs
from repro_torch.netsim import interop
from repro_torch.netsim import mixed as tmixed  # noqa: F401  (registers "mixed")
from test_torch_netsim import jax_lb_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ZOO = [n for n in jlbs.REGISTRY if n != "mixed"]  # the reference's registry order
ENDPOINT = [n for n in ZOO if n != "adaptive_roce"]
N, STEPS, ROUNDS = 48, 30, 2


def _kw(name: str, evs: int) -> dict:
    kw = dict(evs_size=evs)
    if name == "reps":
        kw["freezing_timeout"] = 60  # freezing is entered and left within the run
    return kw


def _leaves_equal(js, ts, where: str) -> None:
    jd, td = {}, interop.lb_state_to_numpy(ts)
    jax_lb_to_numpy("lb_state", js, jd)
    assert jd.keys() == td.keys(), where
    for k in jd:
        assert jd[k].dtype == td[k].dtype and jd[k].shape == td[k].shape, (where, k)
        np.testing.assert_array_equal(td[k], jd[k], err_msg=f"{where}: {k}")


def step_both(jlb, tlb, seed: int, evs: int, jfns=None, jinit=None, tinit=None, steps=STEPS,
              every_call=True):
    """Drive both LBs through ``steps`` ticks of random sends, ACKs (carrying
    the EVs last chosen, or a random one) and timeouts; compare the chosen
    EVs and every state leaf after each call (after each tick only, when not
    ``every_call``).  ``jfns`` replaces the reference's three callbacks;
    ``jinit`` / ``tinit`` rewrite each side's initial state."""
    j_choose, j_ack, j_timeout = jfns or (jlb.choose_ev, jlb.on_ack, jlb.on_timeout)
    rs = np.random.RandomState(seed)
    jbase, tbase = jax.random.PRNGKey(seed), rng.PRNGKey(seed, "cpu")
    js = jlb.init_state(N, jax.random.fold_in(jbase, 777))
    if jinit is not None:
        js = jinit(js)
    ts = tlb.init_state(N, rng.fold_in(tbase, 777))
    if tinit is not None:
        ts = tinit(ts)
    _leaves_equal(js, ts, "init")
    now, last_ev = 0, rs.randint(0, evs, size=N).astype(np.int32)
    B = lambda a: torch.as_tensor(a)
    check = _leaves_equal if every_call else (lambda *a: None)
    for t in range(steps):
        now += int(rs.randint(1, 40))  # gaps both shorter and longer than flowlet / epoch
        jk, tk = jax.random.fold_in(jbase, t), rng.fold_in(tbase, t)
        send = rs.rand(N) < 0.7
        jev, js = j_choose(js, send, jax.random.fold_in(jk, 2), jnp.int32(now))
        tev, ts = tlb.choose_ev(ts, B(send), tlb.draw(rng.fold_in(tk, 2), N), now)
        np.testing.assert_array_equal(tev.numpy(), np.asarray(jev), err_msg=f"evs t={t}")
        check(js, ts, f"choose_ev t={t}")
        last_ev = np.where(send, np.asarray(jev), last_ev).astype(np.int32)
        for r in range(ROUNDS):
            ack, ecn = rs.rand(N) < 0.6, rs.rand(N) < 0.4
            ev = np.where(rs.rand(N) < 0.8, last_ev, rs.randint(0, evs, size=N)).astype(np.int32)
            jkr = jax.random.fold_in(jax.random.fold_in(jk, 4), r)
            tkr = rng.fold_in(rng.fold_in(tk, 4), r)
            js = j_ack(js, ack, ev, ecn, jnp.int32(now), jkr)
            ts = tlb.on_ack(ts, B(ack), B(ev), B(ecn), now, tlb.draw_ack(tkr, N))
            check(js, ts, f"on_ack t={t} round {r}")
        to = rs.rand(N) < 0.15
        js = j_timeout(js, to, jnp.int32(now), jax.random.fold_in(jk, 5))
        ts = tlb.on_timeout(ts, B(to), now, tlb.draw_timeout(rng.fold_in(tk, 5), N))
        _leaves_equal(js, ts, f"tick {t}")
    return js, ts


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("evs", [256, 65536])
@pytest.mark.parametrize("name", ZOO)
def test_registry_lb_steps_match_reference(name, evs):
    jlb = jlbs.make_lb(name, **_kw(name, evs))
    tlb = tlbs.make_lb(name, **_kw(name, evs))
    assert tlb.name == jlb.name and tlb.switch_adaptive == jlb.switch_adaptive
    step_both(jlb, tlb, seed=len(name), evs=evs)


@pytest.mark.parametrize("evs", [256, 65536])
def test_mixed_lb_steps_match_reference(evs):
    bg = (0, 3, 4, 17, 30, 47)
    jlb = jlbs.make_lb("mixed", fg="reps", bg="plb", bg_conns=bg, evs_size=evs)
    tlb = tlbs.make_lb("mixed", fg="reps", bg="plb", bg_conns=bg, evs_size=evs)
    assert tlb.name == jlb.name == "mixed(reps+plb)"
    step_both(jlb, tlb, seed=5, evs=evs)


@pytest.mark.parametrize("evs", [256, 65536])
def test_switch_lb_steps_match_reference(evs):
    """One SwitchLB over every endpoint variant; each branch in turn equals
    the jitted reference (one lax.switch program for all branches), every
    leaf of every variant's slot compared after each tick."""
    variants = lambda m: [m.make_lb(n, **_kw(n, evs)) for n in ENDPOINT]
    jsw = jlbs.SwitchLB(variants(jlbs))
    jfns = tuple(jax.jit(f) for f in (jsw.choose_ev, jsw.on_ack, jsw.on_timeout))
    tsw = tlbs.SwitchLB(variants(tlbs))
    assert tsw.name == jsw.name and tsw.evs_size == evs
    for branch in range(len(ENDPOINT)):
        step_both(jsw, tsw, seed=branch, evs=evs, jfns=jfns, steps=16, every_call=False,
                  jinit=lambda s, b=branch: jsw.with_branch(s, b),
                  tinit=lambda s, b=branch: tsw.with_branch(s, b))


def _step_case(case: str):
    """(load balancer, ACK rounds, initial state's rewrite) for one ``step``
    case."""
    keep = lambda st: st
    if case == "mixed":
        lb = tlbs.make_lb("mixed", fg="reps", bg="plb", bg_conns=(0, 3, 4, 17, 30, 47))
        return lb, ROUNDS, keep
    if case == "switch":
        sw = tlbs.SwitchLB([tlbs.make_lb(n, **_kw(n, 65536)) for n in ENDPOINT])
        return sw, ROUNDS, lambda st: sw.with_branch(st, ENDPOINT.index("reps"))
    if case == "reps-6-rounds":  # more rounds than one reps_tick launch takes
        return tlbs.make_lb("reps", **_kw("reps", 65536)), 6, keep
    if case == "reps-no-freezing":
        lb = tlbs.RepsLB(evs_size=65536, freezing_timeout=60, enable_freezing=False)
        return lb, ROUNDS, keep
    return tlbs.make_lb(case, **_kw(case, 65536)), ROUNDS, keep


@pytest.mark.parametrize("case", ZOO + ["mixed", "switch", "reps-6-rounds", "reps-no-freezing"])
def test_step_equals_separate_calls(case):
    """``LoadBalancer.step`` (the engine's one call per tick; one fused
    kernel launch for REPS) equals ``on_ack`` per round, ``on_timeout`` and
    ``choose_ev`` called one by one, on the same draws: the chosen EVs and
    every state leaf after every tick (tolerance 0)."""
    lb, rounds, init = _step_case(case)
    rs = np.random.RandomState(len(case))
    base = rng.PRNGKey(len(case), "cpu")
    fused = calls = init(lb.init_state(N, rng.fold_in(base, 777)))
    B = lambda a: torch.as_tensor(a)
    now, last_ev = 0, rs.randint(0, lb.evs_size, size=N).astype(np.int32)
    for t in range(20):
        now += int(rs.randint(1, 40))
        tk = rng.fold_in(base, t)
        acks = []
        for r in range(rounds):
            ev = np.where(rs.rand(N) < 0.8, last_ev, rs.randint(0, lb.evs_size, size=N))
            acks.append((B(rs.rand(N) < 0.6), B(ev.astype(np.int32)), B(rs.rand(N) < 0.4),
                         lb.draw_ack(rng.fold_in(rng.fold_in(tk, 4), r), N)))
        timeout, send = B(rs.rand(N) < 0.15), B(rs.rand(N) < 0.7)
        draws = (lb.draw_timeout(rng.fold_in(tk, 5), N), lb.draw(rng.fold_in(tk, 2), N))
        ev_fused, fused = lb.step(fused, acks, timeout, send, draws, now)
        for mask, ev, ecn, draw in acks:
            calls = lb.on_ack(calls, mask, ev, ecn, now, draw)
        calls = lb.on_timeout(calls, timeout, now, draws[0])
        ev_calls, calls = lb.choose_ev(calls, send, draws[1], now)
        np.testing.assert_array_equal(ev_fused.numpy(), ev_calls.numpy(), err_msg=f"evs t={t}")
        a, b = interop.lb_state_to_numpy(fused), interop.lb_state_to_numpy(calls)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{case} t={t}: {k}")
        last_ev = np.where(send.numpy(), ev_fused.numpy(), last_ev).astype(np.int32)


@pytest.mark.parametrize("name,thr", [("plb", 0.5), ("plb", 0.3), ("seqbalance", 0.25),
                                      ("seqbalance", 0.7)])
def test_float_sites_round_like_jitted_xla(name, thr):
    """PLB's ceil(acks * thr) and SeqBalance's marked > acks * thr in float32,
    on counts up to 2**24 and thresholds that are not exact in binary, against
    the jitted reference."""
    n = 1 << 14
    rs = np.random.RandomState(int(thr * 100))
    acks = rs.randint(0, 1 << 24, size=n).astype(np.int32)
    acks[: n // 4] = rs.randint(0, 64, size=n // 4)
    frac = rs.rand(n) * 1.2
    marked = np.minimum((acks * frac).astype(np.int64), 2**31 - 1).astype(np.int32)
    mask = rs.rand(n) < 0.5
    z = np.zeros(n, np.int32)
    if name == "plb":
        jlb, tlb = (m.PlbLB(evs_size=256, ecn_frac_threshold=thr) for m in (jlbs, tlbs))
        end = np.full(n, 10, np.int32)
        js = jlbs.PlbState(ev=z, acks=acks, marked=marked, epoch_end=end, bad_epochs=z)
        ts = tlbs.PlbState(*(torch.as_tensor(a) for a in (z, acks, marked, end, z)))
        key = jax.random.PRNGKey(1)
        js = jax.jit(jlb.on_ack)(js, mask, z, mask, jnp.int32(20), key)
        ts = tlb.on_ack(ts, torch.as_tensor(mask), torch.as_tensor(z), torch.as_tensor(mask), 20,
                        tlb.draw_ack(rng.PRNGKey(1, "cpu"), n))
    else:
        jlb, tlb = (m.SeqBalanceLB(evs_size=256, msg_pkts=0, ecn_frac_threshold=thr)
                    for m in (jlbs, tlbs))
        js = jlbs.SeqBalanceState(ev=z, sent=z, acks=acks, marked=marked)
        ts = tlbs.SeqBalanceState(*(torch.as_tensor(a) for a in (z, z, acks, marked)))
        _, js = jax.jit(jlb.choose_ev)(js, mask, jax.random.PRNGKey(2), jnp.int32(0))
        _, ts = tlb.choose_ev(ts, torch.as_tensor(mask), tlb.draw(rng.PRNGKey(2, "cpu"), n), 0)
    _leaves_equal(js, ts, f"{name} thr={thr}")


# ---------------------------------------------------------------------------
# tests/test_lb_arena.py, mirrored on the port
# ---------------------------------------------------------------------------
def _engine_key(seed: int, tick: int, slot: int) -> torch.Tensor:
    return rng.fold_in(rng.fold_in(rng.PRNGKey(seed, "cpu"), tick), slot)


def test_repath_draws_are_keyed_not_hardcoded():
    """PLB's and MPTCP's RTO re-path draws come from the engine's per-run
    tick key: two seeds draw differently, the same seed draws the same, and
    both equal the reference's draw from that key."""
    mask = torch.ones(8, dtype=torch.bool)
    plb, j_plb = tlbs.PlbLB(evs_size=65536), jlbs.PlbLB(evs_size=65536)
    st = plb.init_state(8, rng.PRNGKey(0, "cpu"))
    ev = {s: plb.on_timeout(st, mask, 37, plb.draw_timeout(_engine_key(s, 37, 5), 8)).ev
          for s in (0, 1)}
    again = plb.on_timeout(st, mask, 37, plb.draw_timeout(_engine_key(0, 37, 5), 8)).ev
    assert not torch.equal(ev[0], ev[1]) and torch.equal(ev[0], again)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 37), 5)
    jst = j_plb.init_state(8, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(
        ev[0].numpy(), np.asarray(j_plb.on_timeout(jst, np.ones(8, bool), jnp.int32(37), jkey).ev))
    mptcp = tlbs.MptcpLB(evs_size=65536)
    stm = mptcp.init_state(8, rng.PRNGKey(0, "cpu"))
    sub = [mptcp.on_timeout(stm, mask, 37, mptcp.draw_timeout(_engine_key(s, 37, 5), 8)).sub_evs
           for s in (0, 1)]
    assert not torch.equal(sub[0], sub[1])


def test_plb_idle_gap_rollover_resets_then_counts():
    """An idle gap spanning the epoch boundary: the completed epoch is
    judged on its own counters, then the first ACK of the next burst counts
    into a fresh epoch."""
    plb = tlbs.PlbLB(evs_size=65536, epoch_ticks=64, ecn_frac_threshold=0.5,
                     repath_after_epochs=1)
    st = plb.init_state(1, rng.PRNGKey(0, "cpu"))
    mask = torch.ones(1, dtype=torch.bool)
    ev = torch.zeros(1, dtype=torch.int32)
    k = rng.PRNGKey(9, "cpu")
    marked, clean = torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool)
    for t in (10, 11):  # burst 1 inside epoch 0: two ECN-marked ACKs
        st = plb.on_ack(st, mask, ev, marked, t, plb.draw_ack(rng.fold_in(k, t), 1))
    assert int(st.acks[0]) == 2 and int(st.marked[0]) == 2
    ev_before = int(st.ev[0])
    st = plb.on_ack(st, mask, ev, clean, 200, plb.draw_ack(rng.fold_in(k, 200), 1))
    assert int(st.ev[0]) != ev_before, "stale congested epoch must repath"
    assert int(st.acks[0]) == 1 and int(st.marked[0]) == 0
    assert int(st.epoch_end[0]) == 200 + 64
    assert int(st.bad_epochs[0]) == 0  # consumed by the repath


def test_switchlb_rejects_mismatched_evs_size():
    with pytest.raises(ValueError, match="evs_size"):
        tlbs.SwitchLB([tlbs.make_lb("ops"), tlbs.make_lb("bitmap")])
    sw = tlbs.SwitchLB([tlbs.make_lb("ops", evs_size=256), tlbs.make_lb("bitmap", evs_size=256)])
    assert sw.evs_size == 256
    with pytest.raises(ValueError, match="switch_adaptive"):
        tlbs.SwitchLB([tlbs.make_lb("ops"), tlbs.make_lb("adaptive_roce")])
    one = tlbs.SwitchLB([tlbs.make_lb("ops")])
    with pytest.raises(ValueError, match="branch"):
        one.with_branch(one.init_state(4, rng.PRNGKey(0, "cpu")), 1)


def test_prime_rotates_within_window_and_rehashes_on_rto():
    lb = tlbs.make_lb("prime", evs_size=4096, sub_bits=3)
    st = lb.init_state(4, rng.PRNGKey(1, "cpu"))
    base0 = st.base.numpy().copy()
    mask = torch.ones(4, dtype=torch.bool)
    evs = []
    for t in range(8):
        ev, st = lb.choose_ev(st, mask, lb.draw(rng.PRNGKey(t, "cpu"), 4), t)
        evs.append(ev.numpy())
    evs = np.stack(evs)
    np.testing.assert_array_equal(st.base.numpy(), base0)  # the flow part stays
    off = (evs - base0[None, :]) % 4096
    assert (off < 8).all(), off  # packets spray inside the 2**sub_bits window
    assert len(np.unique(evs[:, 0])) > 2, "per-packet sub-entropy rotation"
    st2 = lb.on_timeout(st, mask, 99, lb.draw_timeout(rng.PRNGKey(7, "cpu"), 4))
    assert not np.array_equal(st2.base.numpy(), base0)  # an RTO re-hashes the flow part


def test_seqbalance_repaths_only_at_message_boundaries():
    lb = tlbs.make_lb("seqbalance", evs_size=65536, msg_pkts=4, ecn_frac_threshold=0.25)
    st = lb.init_state(2, rng.PRNGKey(0, "cpu"))
    mask = torch.ones(2, dtype=torch.bool)
    ecn = torch.ones(2, dtype=torch.bool)
    ev0 = st.ev.clone()
    for t in range(4):
        ev, st = lb.choose_ev(st, mask, lb.draw(rng.fold_in(rng.PRNGKey(1, "cpu"), t), 2), t)
        assert torch.equal(ev, ev0)  # congested or not, no intra-message re-path
        st = lb.on_ack(st, mask, ev, ecn, t, None)
    ev, st = lb.choose_ev(st, mask, lb.draw(rng.PRNGKey(3, "cpu"), 2), 4)
    assert not torch.equal(ev, ev0)  # the boundary with a fully-marked window


def test_flowlet_table_prefers_uncongested_candidate():
    lb = tlbs.make_lb("flowlet_table", evs_size=65536, table=4, gap_ticks=8)
    st = lb.init_state(1, rng.PRNGKey(0, "cpu"))
    mask = torch.ones(1, dtype=torch.bool)
    ecn = torch.ones(1, dtype=torch.bool)
    ev, st = lb.choose_ev(st, mask, None, 0)
    for t in range(1, 4):  # ECN-mark the active candidate's cached score
        st = lb.on_ack(st, mask, ev, ecn, t, None)
    ev2, st = lb.choose_ev(st, mask, None, 100)  # after a flowlet gap
    assert int(ev2[0]) != int(ev[0])
    cand_before = st.cand.clone()
    st = lb.on_timeout(st, mask, 200, lb.draw_timeout(rng.PRNGKey(5, "cpu"), 1))
    cur = int(st.cur[0])
    assert int(st.cand[0, cur]) != int(cand_before[0, cur])
    assert int(st.score[0, cur]) == 0


def test_switch_lb_row_axis_equals_serial_plain_runs():
    """SwitchLB under a row axis (``(B,)`` branch indices, leaves of B rows
    of N connections stepped as B * N, as the engine hands them over):
    rows on every endpoint branch, some branches on two rows, stepped with
    ``step`` for 16 ticks; each row's active slot and chosen EVs equal the
    plain variant's serial run on that row's events and keys, and every
    other variant's slot of that row stays bit-identical to its init."""
    from repro_torch.netsim.engine import _conn_rows, tree_map

    K, n = len(ENDPOINT), 16
    B = K + 3
    branch = np.arange(B) % K
    variants = lambda: [tlbs.make_lb(v, **_kw(v, 65536)) for v in ENDPOINT]
    sw, plain = tlbs.SwitchLB(variants()), variants()
    keys = torch.stack([rng.PRNGKey(100 + b, "cpu") for b in range(B)])
    init = [sw.init_state(n, rng.fold_in(keys[b], 777)) for b in range(B)]
    rows = sw.with_branch(tree_map(lambda *ls: torch.stack(ls), *init), branch)
    serial = [plain[branch[b]].init_state(n, rng.fold_in(keys[b], 777)) for b in range(B)]
    flat = lambda x: _conn_rows(x, B * n)
    rs = np.random.RandomState(3)
    now, last_ev = 0, rs.randint(0, 65536, size=(B, n)).astype(np.int32)
    for t in range(16):
        now += int(rs.randint(1, 40))
        tk = rng.fold_in(keys, t)
        acks = []
        for r in range(ROUNDS):
            ev = np.where(rs.rand(B, n) < 0.8, last_ev, rs.randint(0, 65536, size=(B, n)))
            acks.append((torch.as_tensor(rs.rand(B, n) < 0.6),
                         torch.as_tensor(ev.astype(np.int32)),
                         torch.as_tensor(rs.rand(B, n) < 0.4),
                         rng.fold_in(rng.fold_in(tk, 4), r)))
        timeout = torch.as_tensor(rs.rand(B, n) < 0.15)
        send = torch.as_tensor(rs.rand(B, n) < 0.7)
        k_to, k_send = rng.fold_in(tk, 5), rng.fold_in(tk, 2)
        evs, out = sw.step(
            flat(rows),
            [(m.reshape(-1), e.reshape(-1), c.reshape(-1), flat(sw.draw_ack(k, n)))
             for m, e, c, k in acks],
            timeout.reshape(-1), send.reshape(-1),
            (flat(sw.draw_timeout(k_to, n)), flat(sw.draw(k_send, n))), now)
        rows = tree_map(lambda new, old: new.reshape(old.shape), out, rows)
        for b in range(B):
            v = plain[branch[b]]
            ev_b, serial[b] = v.step(
                serial[b], [(m[b], e[b], c[b], v.draw_ack(k[b], n)) for m, e, c, k in acks],
                timeout[b], send[b], (v.draw_timeout(k_to[b], n), v.draw(k_send[b], n)), now)
            np.testing.assert_array_equal(evs[b * n:(b + 1) * n].numpy(), ev_b.numpy(),
                                          err_msg=f"evs t={t} row {b}")
        last_ev = np.where(send.numpy(), evs.view(B, n).numpy(), last_ev).astype(np.int32)
    bidx, slots = rows
    np.testing.assert_array_equal(bidx.numpy(), branch)
    for b in range(B):
        got = interop.lb_state_to_numpy(tree_map(lambda x: x[b], slots))
        for i in range(K):
            want = interop.lb_state_to_numpy(serial[b] if i == branch[b] else init[b][1][i],
                                             f"lb_state.{i}")
            for k, a in want.items():
                assert got[k].dtype == a.dtype and np.array_equal(got[k], a), (b, i, k)
