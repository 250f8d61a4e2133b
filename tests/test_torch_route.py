"""The port's routing step (``ops.next_queue`` on CPU tensors, i.e. its
plain version ``ref.next_queue_ref``) against the JAX engine's own routing
sequence (``repro/netsim/engine.py``, the arrivals stage): jnp gathers of
the arrivals' packet rows and of the connection tables, then
``Topology.next_queue``, then ``where(a_valid, target, NQ)`` — bit for bit
(tolerance 0), on 2- and 3-tier fabrics with and without adaptive routing.

The inputs (``route_case``, shared with the card's test in
tests/test_torch_cuda.py, which holds the CUDA kernel against the same plain
version, as chip_smoke.py does) are made from a numpy seed so that every
hard case shows: empty slots (``a_idx = NP``) among the arrivals, fresh
injections (hop 0, current queue -1), every queue region as the current
queue, queue lengths with ties (so the first-least rule decides) and a
nonzero penalty on some queues."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arcane_paper as jpresets
from repro.netsim import topology as jtopo
from repro.netsim.engine import PCONN, PCURQ, PEV, PHOP
from repro_torch.configs import arcane_paper as tpresets
from repro_torch.kernels import ops
from repro_torch.kernels.next_queue import RouteGeometry
from repro_torch.netsim import topology as ttopo
from test_torch_cuda import ROUTE_FABRICS, route_case

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

def _topologies(name, kw):
    jcfg = getattr(jpresets, name).replace(**kw)
    tcfg = getattr(tpresets, name).replace(**kw)
    return jtopo.Topology.build(jcfg), ttopo.Topology.build(tcfg)


def _jax_engine_route(jt, c, adaptive):
    """The reference engine's arrivals-stage routing, as it is written there."""
    NP, NC, NQ = c["NP"], c["NC"], jt.n_queues
    pkt, a_idx = jnp.asarray(c["pkt"]), jnp.asarray(c["a_idx"])
    conn_src, conn_dst = jnp.asarray(c["conn_src"]), jnp.asarray(c["conn_dst"])
    a_valid = a_idx < NP
    A = pkt[:, jnp.minimum(a_idx, NP - 1)]
    a_conn = jnp.where(a_valid, A[PCONN], 0)
    a_ev = jnp.where(a_valid, A[PEV], 0)
    a_inj = jnp.where(a_valid, A[PHOP], 1) == 0
    a_cur = jnp.where(a_valid, A[PCURQ], 0)
    a_src = conn_src[jnp.clip(a_conn, 0, NC - 1)]
    a_dst = conn_dst[jnp.clip(a_conn, 0, NC - 1)]
    q_len_eff = jnp.asarray(c["q_len"]) + jnp.asarray(c["q_pen"])
    target = jt.next_queue(a_inj, a_cur, a_conn, a_ev, a_src, a_dst, q_len_eff,
                           adaptive=adaptive)
    return np.asarray(jnp.where(a_valid, target, NQ))


def _port_route(tt, c, adaptive):
    NP = c["NP"]
    t = {k: torch.as_tensor(v) for k, v in c.items() if isinstance(v, np.ndarray)}
    A = t["pkt"][:, t["a_idx"].clamp(max=NP - 1)]
    return tt.route(t["a_idx"], NP, A[PHOP], A[PCURQ], A[PCONN], A[PEV], t["conn_src"],
                    t["conn_dst"], t["q_len"], t["q_pen"], adaptive=adaptive).numpy()


def _ties_decide(jt, c):
    """Whether the data has injections whose least-loaded ToR uplinks tie,
    so that the first-least rule picks another port than the last-least."""
    cfg = jt.cfg
    n = cfg.uplinks_per_tor if cfg.tiers == 2 else cfg.aggs_per_pod
    ok = c["a_idx"] < c["NP"]
    rows = c["pkt"][:, c["a_idx"][ok]]
    conn = rows[PCONN][rows[PHOP] == 0]
    src_tor = c["conn_src"][conn] // cfg.hosts_per_tor
    lens = (c["q_len"] + c["q_pen"])[jt.t0_up_base + src_tor[:, None] * n + np.arange(n)]
    first, last = lens.argmin(1), n - 1 - lens[:, ::-1].argmin(1)
    return bool((first != last).any())


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tiers", [2, 3])
def test_route_matches_jax_engine_sequence(tiers, adaptive):
    for i, (name, kw) in enumerate(ROUTE_FABRICS[tiers]):
        jt, tt = _topologies(name, kw)
        for seed in range(3):
            c = route_case(jt, 10 * tiers + seed + i, penalty=seed != 1)
            want = _jax_engine_route(jt, c, adaptive)
            got = _port_route(tt, c, adaptive)
            assert got.dtype == np.int32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name} seed {seed}")
            empty = c["a_idx"] >= c["NP"]
            assert empty.any() and (got[empty] == jt.n_queues).all()
            assert ((got >= 0) & (got < jt.n_queues))[~empty].all()
        assert _ties_decide(jt, c)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tiers", [2, 3])
def test_reference_form_matches_jax_next_queue(tiers, adaptive):
    """``Topology.next_queue``'s own signature (one value per arrival, bool
    injection flags) with the penalty passed to the kernel, against the JAX
    function on ``q_len + q_penalty``; injections keep their -1 queue."""
    name, kw = ROUTE_FABRICS[tiers][0]
    jt, tt = _topologies(name, kw)
    c = route_case(jt, 7 + tiers, K=3000, NP=3000)
    rows = c["pkt"][:, c["a_idx"].clip(max=c["NP"] - 1)]
    conn = rows[PCONN]
    args = [rows[PHOP] == 0, rows[PCURQ], conn, rows[PEV], c["conn_src"][conn],
            c["conn_dst"][conn]]
    want = np.asarray(jt.next_queue(*[jnp.asarray(a) for a in args],
                                    jnp.asarray(c["q_len"] + c["q_pen"]), adaptive=adaptive))
    got = ops.next_queue(tt.geometry, *[torch.as_tensor(a) for a in args],
                         torch.as_tensor(c["q_len"]), adaptive,
                         q_penalty=torch.as_tensor(c["q_pen"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (args[1] == -1).any()


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tiers", [2, 3])
def test_rows_equal_one_row_calls(tiers, adaptive):
    """A fleet's arrivals ``(B, K)`` in one call: every row of the engine
    form (shared connection tables; ``q_len`` per row; penalty shared and
    per row) equals the one-row call on that row and the JAX engine's
    routing of it, and so does every row of the reference form."""
    name, kw = ROUTE_FABRICS[tiers][-1]
    jt, tt = _topologies(name, kw)
    g, B = tt.geometry, 4
    cases = [route_case(jt, 40 * tiers + b) for b in range(B)]
    src, dst = cases[0]["conn_src"], cases[0]["conn_dst"]  # one workload for the fleet
    for c in cases:
        c.update(conn_src=src, conn_dst=dst)
    NP = cases[0]["NP"]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    rows = [c["pkt"][:, c["a_idx"].clip(max=NP - 1)] for c in cases]
    fields = [t(np.stack([r[f] for r in rows])) for f in (PHOP, PCURQ, PCONN, PEV)]
    a_idx = t(np.stack([c["a_idx"] for c in cases]))
    q_len = t(np.stack([c["q_len"] for c in cases]))
    for pen_rows in (False, True):
        pens = [c["q_pen"] if pen_rows else cases[0]["q_pen"] for c in cases]
        q_pen = t(np.stack(pens)) if pen_rows else t(pens[0])
        got = ops.next_queue(g, *fields, t(src), t(dst), q_len, adaptive, q_penalty=q_pen,
                             a_idx=a_idx, n_pkt=NP)
        assert got.shape == (B, a_idx.shape[1]) and got.dtype == torch.int32
        conn = fields[2].clamp(0, len(src) - 1)
        flat = (fields[0] == 0, fields[1], fields[2], fields[3], t(src)[conn], t(dst)[conn])
        got_ref = ops.next_queue(g, *flat, q_len, adaptive, q_penalty=q_pen)
        for b in range(B):
            one = ops.next_queue(g, *(x[b] for x in fields), t(src), t(dst), q_len[b],
                                 adaptive, q_penalty=t(pens[b]), a_idx=a_idx[b], n_pkt=NP)
            np.testing.assert_array_equal(got[b].numpy(), one.numpy())
            c = dict(cases[b], q_pen=pens[b])
            np.testing.assert_array_equal(got[b].numpy(), _jax_engine_route(jt, c, adaptive))
            one_ref = ops.next_queue(g, *(x[b] for x in flat), q_len[b], adaptive,
                                     q_penalty=t(pens[b]))
            np.testing.assert_array_equal(got_ref[b].numpy(), one_ref.numpy())
        ok = a_idx < NP
        np.testing.assert_array_equal(got_ref.numpy()[ok.numpy()], got.numpy()[ok.numpy()])


def test_geometry_matches_topology_and_bad_layouts_raise():
    for tiers in (2, 3):
        for name, kw in ROUTE_FABRICS[tiers]:
            jt, tt = _topologies(name, kw)
            g = tt.geometry
            assert (g.tiers, g.n_queues, g.t0_up_base, g.core_down_base, g.t0_down_base) == (
                tiers, jt.n_queues, jt.t0_up_base, jt.core_down_base, jt.t0_down_base)
            if tiers == 3:
                assert (g.agg_up_base, g.agg_down_base, g.n_pods) == (
                    jt.agg_up_base, jt.agg_down_base, jt.cfg.n_pods)
    _, tt = _topologies("FATTREE_128_3T", {})
    q = torch.zeros(3, dtype=torch.int32)
    args = (q == 0, q, q, q, q, q, torch.zeros(tt.n_queues, dtype=torch.int32), False)
    for bad, match in [(tt.geometry._replace(tiers=4), "tiers=4"),
                       (tt.geometry._replace(agg_uplinks=0), "agg_uplinks"),
                       (tt.geometry._replace(n_pods=0), "n_pods"),
                       (tuple(tt.geometry), "RouteGeometry")]:
        with pytest.raises((ValueError, TypeError), match=match):
            ops.next_queue(bad, *args)
    assert isinstance(tt.geometry, RouteGeometry)
