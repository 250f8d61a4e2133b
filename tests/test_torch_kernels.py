"""The plain versions of the port's five kernels against the reference's
oracles (repro.kernels.ref) and its Pallas kernels in interpret mode, on
seeded numpy inputs with several tiles, sentinels and saturation — bit for
bit (tolerance 0).  The CUDA kernels themselves are held against the same
plain versions by tests/test_torch_cuda.py (marked ``cuda``, skipped without
a GPU) and by chip_smoke.py."""
import numpy as np
import pytest
import torch

from repro.kernels import ecmp_hash as jeh
from repro.kernels import ops as jops
from repro.kernels import queue_tick as jqt
from repro.kernels import ref as jref
from repro.kernels import reps_update as jru
from repro.kernels import seg_rank as jsr
from repro.kernels import seg_sum as jss
from repro_torch.configs import FATTREE_32_CI
from repro_torch.kernels import ops, ref
from repro_torch.netsim import Topology

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

RS = np.random.RandomState


def _seg(rs, K, S, sentinel=0.3):
    seg = rs.randint(0, S, size=K)
    seg[rs.rand(K) < sentinel] = S  # the engine's sentinel segment
    seg[rs.rand(K) < 0.03] = S + 5  # further out of range
    return seg.astype(np.int32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("F,K,S", [(5, 128, 387), (2, 300, 129), (4, 128, 17), (1, 1, 1)])
def test_seg_sum_plain_vs_reference(F, K, S):
    rs = RS(F * 1000 + K)
    seg = _seg(rs, K, S)
    vals = rs.randint(-3, 60, size=(F, K)).astype(np.int32)
    got = ops.seg_sum(_t(seg), _t(vals), S).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.seg_sum_ref(seg, vals, S)))
    np.testing.assert_array_equal(got, np.asarray(jss.seg_sum_pallas(seg, vals, S, interpret=True)))


@pytest.mark.parametrize("kinds,K,S", [
    ("ibiii", 128, 387),  # the engine's feedback call (F=5, K=MAX_EV, S=(R+1)(NC+1))
    ("ibiiibb", 128, 387),  # the same with trimming (F=7)
    ("bb", 128, 129),  # RTO and injection
    ("bbbb", 96, 129),  # delivery (host downlinks of the queue axis)
    ("i", 1, 1), ("b", 300, 17), ("bibibibi", 300, 40),
])
def test_seg_sum_plain_field_sequence_vs_reference(kinds, K, S):
    """Fields as they are — bool and int32 mixed, no stack, no cast — equal
    the reference's oracle on the stacked int32 fields."""
    rs = RS(K * 31 + S + len(kinds))
    seg = _seg(rs, K, S)
    fields = [rs.rand(K) < 0.4 if k == "b" else rs.randint(-3, 60, size=K).astype(np.int32)
              for k in kinds]
    got = ops.seg_sum(_t(seg), [_t(f) for f in fields], S).numpy()
    stacked = np.stack([f.astype(np.int32) for f in fields])
    np.testing.assert_array_equal(got, np.asarray(jref.seg_sum_ref(seg, stacked, S)))
    np.testing.assert_array_equal(got, ops.seg_sum(_t(seg), _t(stacked), S).numpy())


def test_seg_sum_plain_row_axis():
    rs = RS(2)
    segs = np.stack([_seg(rs, 200, 40) for _ in range(3)])
    vals = rs.randint(0, 9, size=(3, 4, 200)).astype(np.int32)
    got = ref.seg_sum_ref(_t(segs), _t(vals), 40)
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(jref.seg_sum_ref(segs[b], vals[b], 40)))


@pytest.mark.parametrize("K,S,n_ids", [(128, 129, 129), (512, 385, 40), (300, 50, 5)])
def test_seg_rank_plain_vs_reference(K, S, n_ids):
    rs = RS(K + S)
    seg = rs.randint(0, n_ids, size=K).astype(np.int32)
    seg[rs.rand(K) < 0.25] = S
    seg[rs.rand(K) < 0.03] = S + 9
    got = ops.seg_rank(_t(seg), S).numpy()
    # the Pallas kernel ranks out-of-range ids 0, as the plain version does
    np.testing.assert_array_equal(got, np.asarray(jsr.seg_rank_pallas(seg, S, interpret=True)))
    # the pairwise oracle ranks every id; compare the in-range lanes
    inr = seg < S
    np.testing.assert_array_equal(got[inr], np.asarray(jref.seg_rank_ref(seg, S))[inr])
    assert (got[~inr] == 0).all()


# ---------------------------------------------------------------------------
def _hash_inputs(rs, shape):
    flow = rs.randint(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    ev = rs.randint(0, 65536, size=shape).astype(np.int32)
    salt = rs.randint(0, 2**31, size=shape, dtype=np.int64).astype(np.int32)
    salt.reshape(-1)[: salt.size // 4] = 2**31 - 1 - rs.randint(0, 8000, size=salt.size // 4)
    return flow, ev, salt


@pytest.mark.parametrize("nports", [1, 4, 13, 16])
def test_ecmp_hash_plain_vs_reference(nports):
    """The plain version against the reference's oracle on a flat (K,) input
    (K not a multiple of 128, salts near 2**31 as the 3-tier agg_global +
    7919 gives) and against the Pallas kernel in interpret mode on its
    (R, 128) tiles, through the reference's own ``ops.ecmp_hash``."""
    rs = RS(nports)
    flow, ev, salt = _hash_inputs(rs, (1000,))
    got = ops.ecmp_hash(_t(flow), _t(ev), _t(salt), nports).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.ecmp_hash_ref(flow, ev, salt, nports)))
    tiles = [a[:896].reshape(7, 128) for a in (flow, ev, salt)]
    n = np.int32(nports)
    np.testing.assert_array_equal(
        got[:896].reshape(7, 128), np.asarray(jops.ecmp_hash(*tiles, n)))
    np.testing.assert_array_equal(
        got[:896].reshape(7, 128),
        np.asarray(jeh.ecmp_hash_pallas(*tiles, n, interpret=True)))


def test_ecmp_hash_plain_row_axis_and_checks():
    rs = RS(3)
    flow, ev, salt = _hash_inputs(rs, (3, 512))
    got = ref.ecmp_hash_ref(_t(flow), _t(ev), _t(salt), 16)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(jref.ecmp_hash_ref(flow[b], ev[b], salt[b], 16)))
    with pytest.raises(ValueError, match="nports >= 1"):
        ops.ecmp_hash(_t(flow), _t(ev), _t(salt), 0)


# ---------------------------------------------------------------------------
def _reps_inputs(rs, N, frozen=0.3):
    b = lambda p: (rs.rand(N) < p)
    i = lambda lo, hi: rs.randint(lo, hi, size=N).astype(np.int32)
    state = [
        rs.randint(0, 65536, size=(N, 8)).astype(np.int32),
        rs.rand(N, 8) < 0.5,
        i(0, 8), i(0, 9), i(0, 3), b(frozen), i(0, 3000), i(0, 3),
    ]
    events = [b(0.5), i(0, 65536), b(0.3), b(0.2), b(0.6), i(0, 65536)]
    return state, events


@pytest.mark.parametrize("N", [128, 300])
def test_reps_tick_plain_vs_reference(N):
    rs = RS(N)
    for step in range(3):
        state, events = _reps_inputs(rs, N)
        now = int(rs.randint(0, 3000))
        got = ops.reps_tick(*[_t(a) for a in state + events], now, 32, 800)
        args = state + events + [now, 32, 800]
        want = jref.reps_tick_ref(*args)
        pallas = jru.reps_tick_pallas(*[np.asarray(a, np.int32) if isinstance(a, np.ndarray) else a
                                        for a in args], interpret=True)
        for g, w, p in zip(got, want, pallas):
            g = g.numpy().astype(np.int32)
            np.testing.assert_array_equal(g, np.asarray(w).astype(np.int32))
            np.testing.assert_array_equal(g, np.asarray(p))


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("N", [128, 300])
def test_reps_tick_plain_rounds_vs_reference_composed(R, N):
    """One multi-round tick (R ACK rounds, then timeout and send) equals the
    reference's single-round tick composed R times with ACK events only,
    then once with the timeout and send events — for the reference's
    oracle and for its Pallas kernel in interpret mode."""
    rs = RS(100 * R + N)
    zi = np.zeros(N, np.int32)
    for step in range(2):
        state, _ = _reps_inputs(rs, N)
        acks = [(rs.rand(N) < 0.6, rs.randint(0, 65536, size=N).astype(np.int32),
                 rs.rand(N) < 0.3) for _ in range(R)]
        to, send, rand_ev = rs.rand(N) < 0.3, rs.rand(N) < 0.6, rs.randint(0, 65536, size=N)
        rand_ev = rand_ev.astype(np.int32)
        now = int(rs.randint(0, 3000))
        masks, evs, ecns = ([_t(a[c]) for a in acks] for c in range(3))
        got = ops.reps_tick(*[_t(a) for a in state], tuple(masks), tuple(evs), tuple(ecns),
                            _t(to), _t(send), _t(rand_ev), now, 32, 800)
        got = [g.numpy().astype(np.int32) for g in got]
        for fn in (jref.reps_tick_ref,
                   lambda *a: jru.reps_tick_pallas(*a, interpret=True)):
            st = [np.asarray(a, np.int32) for a in state]
            for m, e, c in acks:
                out = fn(*st, m.astype(np.int32), e, c.astype(np.int32), zi, zi, rand_ev,
                         now, 32, 800)
                st = [np.asarray(o).astype(np.int32) for o in out[:8]]
            out = fn(*st, zi, zi, zi, to.astype(np.int32), send.astype(np.int32), rand_ev,
                     now, 32, 800)
            for g, w in zip(got, out):
                np.testing.assert_array_equal(g, np.asarray(w).astype(np.int32))


def test_reps_tick_plain_rounds_must_agree():
    rs = RS(9)
    state, events = _reps_inputs(rs, 16)
    m = _t(events[0])
    with pytest.raises(ValueError, match="disagree on the rounds"):
        ops.reps_tick(*[_t(a) for a in state], (m, m), (_t(events[1]),), None,
                      None, None, None, 5, 32, 800)


def test_reps_tick_plain_absent_events_are_noops():
    """An event class passed as None acts as all-zero (the engine passes only
    the class its stage has)."""
    rs = RS(5)
    state, events = _reps_inputs(rs, 64)
    z = [np.zeros(64, bool), np.zeros(64, np.int32), np.zeros(64, bool),
         np.zeros(64, bool), np.zeros(64, bool), np.zeros(64, np.int32)]
    for keep in ([0, 1, 2], [3], [4, 5]):
        ev_none = [_t(events[k]) if k in keep else None for k in range(6)]
        ev_zero = [_t(events[k] if k in keep else z[k]) for k in range(6)]
        a = ops.reps_tick(*[_t(s) for s in state], *ev_none, 2000, 32, 800)
        b = ops.reps_tick(*[_t(s) for s in state], *ev_zero, 2000, 32, 800)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K,Q,busy,serve", [(512, 384, 384, False), (512, 384, 12, True),
                                            (256, 96, 5, True), (300, 60, 7, True)])
def test_queue_tick_plain_vs_reference(K, Q, busy, serve):
    rs = RS(K + Q + busy)
    cap, kmin, kmax = 85, 17, 68
    tgt = rs.randint(0, busy, size=K).astype(np.int32)
    tgt[rs.rand(K) < 0.3] = Q  # the engine's padding target
    qlen = rs.randint(0, cap + 1, size=Q).astype(np.int32)
    qlen[: max(1, Q // 8)] = cap  # saturated queues
    u = rs.rand(K).astype(np.float32)
    sv = (rs.rand(Q) < 0.5) if serve else np.zeros(Q, bool)
    got = ops.queue_tick(_t(tgt), _t(u), _t(qlen), _t(sv) if serve else None, cap, kmin, kmax)
    got = [g.numpy() for g in got]
    want = jref.queue_tick_ref(tgt, u, qlen, sv.astype(np.int32), cap, kmin, kmax, tile=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    pallas = jqt.queue_tick_pallas(tgt, u, qlen, sv.astype(np.int32), cap, kmin, kmax,
                                   interpret=True)
    for g, p in zip(got, pallas):
        np.testing.assert_array_equal(g, np.asarray(p))
    assert got[1].sum() > 0 and (~got[1] & (tgt < Q)).sum() > 0  # accepts and tail drops


def test_ops_dispatch_cpu_uses_plain_versions_and_counts_nothing():
    ops.reset_launch_counts()
    seg = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    ops.seg_sum(seg, torch.ones((2, 4), dtype=torch.int32), 3)
    ops.seg_rank(seg, 3)
    ops.ecmp_hash(seg, seg, seg, 4)
    g = Topology.build(FATTREE_32_CI).geometry
    ops.next_queue(g, seg > 0, seg, seg, seg, seg, seg, torch.zeros(g.n_queues, dtype=torch.int32),
                   True)
    tables = Topology.build(FATTREE_32_CI.replace(fabric="mesh:tors=4,hosts=8,planes=2")).tables(
        "cpu")
    ops.next_queue_table(tables, seg > 0, seg, seg, seg, seg, seg,
                         torch.zeros(tables.n_queues, dtype=torch.int32), True)
    assert ops.launch_counts() == {
        "seg_sum": 0, "seg_rank": 0, "reps_tick": 0, "queue_tick": 0, "ecmp_hash": 0,
        "next_queue": 0, "next_queue_table": 0}


# ---------------------------------------------------------------------------
def _busy_queue_case(rs, K, Q, cap=85):
    """Arrivals crowded on a few queues near capacity, so that tail drops
    fall in later 128-arrival tiles too; 30 % padding (target Q) and a few
    negative targets."""
    hot = rs.randint(0, Q, size=min(Q, 6))
    tgt = np.where(rs.rand(K) < 0.6, hot[rs.randint(0, len(hot), size=K)], rs.randint(0, Q, size=K))
    tgt[rs.rand(K) < 0.3] = Q
    tgt[rs.rand(K) < 0.02] = -2
    qlen = rs.randint(0, cap + 1, size=Q)
    qlen[hot] = cap - rs.randint(0, 40, size=len(hot))
    return tgt.astype(np.int32), qlen.astype(np.int32)


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("Q", [20, 384])
@pytest.mark.parametrize("K", [300, 512, 2048])
def test_queue_tick_plain_default_form_vs_pallas(K, Q, serve):
    """The default form (the TPU kernel's function) is bit-equal to
    ``queue_tick_pallas`` in interpret mode with busy queues whose tail
    drops fall in later tiles."""
    rs = RS(7 * K + Q + serve)
    cap, kmin, kmax = 85, 17, 68
    tgt, qlen = _busy_queue_case(rs, K, Q, cap)
    u = rs.rand(K).astype(np.float32)
    sv = rs.rand(Q) < 0.5 if serve else np.zeros(Q, bool)
    got = ops.queue_tick(_t(tgt), _t(u), _t(qlen), _t(sv) if serve else None, cap, kmin, kmax)
    assert len(got) == 4
    got = [g.numpy() for g in got]
    pallas = jqt.queue_tick_pallas(tgt, u, qlen, sv.astype(np.int32), cap, kmin, kmax,
                                   interpret=True)
    for g, p in zip(got, pallas):
        np.testing.assert_array_equal(g, np.asarray(p))
    real = (tgt >= 0) & (tgt < Q)
    later = np.arange(K) >= 128
    assert (got[1] & later).sum() > 0 and (~got[1] & real & later).sum() > 0


def _jax_engine_mark_and_slot(pos, accept, u, target, q_head, kmin, kmax, pmax, qcap):
    """The reference engine's RED mark and ring slot (src/repro/netsim/engine.py,
    arrivals stage), jitted as the engine is, on the Pallas kernel's outputs."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(pos, accept, u, target, q_head):
        mark_p = jnp.clip((pos.astype(jnp.float32) - kmin) / float(kmax - kmin), 0.0, 1.0) * pmax
        slot = (q_head.at[target].get(mode="fill", fill_value=0) + pos) % qcap
        return accept & (u < mark_p), slot

    return [np.asarray(a) for a in f(pos, accept, u, target, q_head)]


@pytest.mark.parametrize("pmax", [1.0, 0.5])
@pytest.mark.parametrize("K,Q", [(512, 384), (2048, 20), (300, 384)])
def test_queue_tick_plain_engine_form_vs_jax_engine_arithmetic(K, Q, pmax):
    """The engine form (``red_rcp``, ``pmax``, ``q_head``) is bit-equal to the
    JAX engine's own arithmetic composed on the Pallas kernel's outputs.  At
    FATTREE_128's kmin = 17, kmax = 68 the engine's reciprocal multiply and
    the kernel's division differ by one ulp at 8 ramp positions; half of the
    arrivals get ``u`` exactly at the smaller of the two ramps, so the two
    forms' marks must differ there."""
    rs = RS(K + Q + int(pmax * 10))
    cap, kmin, kmax, qcap = 85, 17, 68, 85
    tgt, qlen = _busy_queue_case(rs, K, Q, cap)
    tgt[tgt < 0] = Q  # the engine pads with Q; jnp would wrap a negative index
    cool = qlen < kmin  # put them on the ramp, where the two marks can differ
    qlen[cool] = rs.randint(kmin - 3, kmax, size=int(cool.sum()))
    q_head = rs.randint(0, 4 * qcap, size=Q).astype(np.int32)
    zero = np.zeros(Q, np.int32)
    p_qlen, p_acc, _, p_pos = (np.asarray(a) for a in jqt.queue_tick_pallas(
        tgt, np.zeros(K, np.float32), qlen, zero, cap, kmin, kmax, interpret=True))
    rcp = np.float32(1.0) / np.float32(kmax - kmin)
    f32 = np.float32
    ramp_div = np.clip((p_pos - kmin).astype(f32) / f32(kmax - kmin), 0, 1)
    ramp_rcp = np.clip((p_pos.astype(f32) - f32(kmin)) * rcp, 0, 1)
    edge = (np.minimum(ramp_div, ramp_rcp) * f32(pmax)).astype(f32)
    u = np.where(rs.rand(K) < 0.5, edge, rs.rand(K).astype(f32)).astype(f32)
    want_mark, want_slot = _jax_engine_mark_and_slot(p_pos, p_acc, u, tgt, q_head, kmin, kmax,
                                                     pmax, qcap)
    got = ops.queue_tick(_t(tgt), _t(u), _t(qlen), None, cap, kmin, kmax, red_rcp=float(rcp),
                         pmax=pmax, q_head=_t(q_head), qcap=qcap)
    assert len(got) == 5
    qlen_g, acc_g, mark_g, pos_g, slot_g = (g.numpy() for g in got)
    np.testing.assert_array_equal(qlen_g, p_qlen)
    np.testing.assert_array_equal(acc_g, p_acc)
    np.testing.assert_array_equal(pos_g, p_pos)
    np.testing.assert_array_equal(mark_g, want_mark)
    np.testing.assert_array_equal(slot_g, want_slot)
    default = ops.queue_tick(_t(tgt), _t(u), _t(qlen), None, cap, kmin, kmax)[2].numpy()
    if pmax == 1.0:  # the one-ulp ramp positions are hit
        assert (default != mark_g).any()
        assert set(p_pos[default != mark_g]) <= {20, 23, 29, 41, 42, 65, 66, 67}


@pytest.mark.parametrize("case", ["passes", "one_key", "all_sentinel"])
def test_seg_rank_plain_edge_cases_vs_pallas(case):
    """K = 4096 (many of the kernel's passes), one key repeated everywhere,
    and ids that are all out of range."""
    rs = RS(len(case))
    K, S = (4096, 50) if case == "passes" else (1000, 129)
    if case == "passes":
        seg = rs.randint(0, 7, size=K)
        seg[rs.rand(K) < 0.25] = S
    elif case == "one_key":
        seg = np.full(K, 3)
    else:
        seg = np.where(rs.rand(K) < 0.5, S, -1)
    seg = seg.astype(np.int32)
    got = ops.seg_rank(_t(seg), S).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsr.seg_rank_pallas(seg, S, interpret=True)))
    if case == "one_key":
        np.testing.assert_array_equal(got, np.arange(K))
    if case == "all_sentinel":
        assert (got == 0).all()
