"""The port on a CUDA device: each hand-written kernel against its plain
version (``next_queue`` with a fleet's row axis and per-row connection
tables, the flat hash with per-lane port counts), and short simulations and
fleets on the card (ECMP-hashing, REPS, zoo and adaptive load balancers; 2-
and 3-tier; a fleet of rows with their own scenarios through
``run_summary``) against the same ones on the CPU — bit for bit.  Marked
``cuda``; without a GPU every test skips with a reason.  This file imports
no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import FATTREE_32_CI, arcane_paper as presets
from repro_torch.core import make_lb
from repro_torch.kernels import ops, ref
from repro_torch.netsim import Simulator, Topology, failures, sim_state_to_numpy, workloads
from repro_torch.netsim.engine import PCONN, PCURQ, PEV, PF, PHOP

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, a):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


# ---------------------------------------------------------------------------
# routing cases, shared with tests/test_torch_route.py (which holds the plain
# version against JAX on them); numpy only, so this file needs no JAX
ROUTE_FABRICS = {
    2: [("FATTREE_128", {}), ("FATTREE_128_OVERSUB4", {})],
    3: [("FATTREE_128_3T", {}),
        ("FATTREE_32_CI", dict(hosts_per_tor=4, tiers=3, tors_per_pod=2, aggs_per_pod=4,
                               agg_uplinks=2))],
}


def route_regions(topo):
    """``[start, end)`` of every queue region of a topology's layout (the
    port's or the reference's: both have these attributes)."""
    if topo.cfg.tiers == 2:
        bounds = [topo.t0_up_base, topo.core_down_base, topo.t0_down_base, topo.n_queues]
    else:
        bounds = [topo.t0_up_base, topo.agg_up_base, topo.core_down_base, topo.agg_down_base,
                  topo.t0_down_base, topo.n_queues]
    return list(zip(bounds[:-1], bounds[1:]))


def route_case(topo, seed, K=None, NP=700, NC=128, penalty=True):
    """Packet table, arrival slots, connection tables, queue lengths and
    penalty for K arrivals (default: the engine's MAX_ARR = NQ + NH): empty
    slots among the arrivals, fresh injections (hop 0, queue -1), every
    region's first and last queue as a current queue, lengths in [0, 3) (so
    ties are common) and, with ``penalty``, 4 x capacity on 15 % of queues."""
    rs = np.random.RandomState(seed)
    cfg, NQ = topo.cfg, topo.n_queues
    K = K or NQ + cfg.n_hosts
    conn_src = rs.randint(0, cfg.n_hosts, size=NC)
    near = rs.rand(NC) < 0.3  # same-ToR pairs as well as far ones
    conn_dst = np.where(near, (conn_src // cfg.hosts_per_tor) * cfg.hosts_per_tor
                        + rs.randint(0, cfg.hosts_per_tor, size=NC),
                        rs.randint(0, cfg.n_hosts, size=NC))
    pkt = np.zeros((PF, NP + 1), np.int32)
    pkt[PCONN] = rs.randint(0, NC, size=NP + 1)
    pkt[PEV] = rs.randint(0, 65536, size=NP + 1)
    pkt[PHOP] = rs.randint(1, 5, size=NP + 1)
    pkt[PCURQ] = rs.randint(0, NQ, size=NP + 1)
    edges = [q for lo, hi in route_regions(topo) for q in (lo, hi - 1)]
    pkt[PCURQ, : len(edges)] = edges
    inj = rs.rand(NP + 1) < 0.3
    inj[: len(edges)] = False
    pkt[PHOP, inj] = 0
    pkt[PCURQ, inj] = -1
    a_idx = rs.randint(0, NP, size=K)
    a_idx[rs.rand(K) < 0.25] = NP
    a_idx[-5:] = NP
    a_idx[: len(edges)] = np.arange(len(edges))
    q_len = rs.randint(0, 3, size=NQ)
    q_pen = np.where(rs.rand(NQ) < 0.15, 4 * cfg.queue_capacity, 0) if penalty \
        else np.zeros(NQ, np.int64)
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(pkt=pkt, a_idx=i32(a_idx), conn_src=i32(conn_src), conn_dst=i32(conn_dst),
                q_len=i32(q_len), q_pen=i32(q_pen), NP=NP, NC=NC)


# generated fabrics of every kind and degenerate corners, shared with
# tests/test_torch_topogen.py (which holds the table form's plain version
# against JAX's TableTopology on them)
TABLE_FABRICS = [
    "clos3:pods=2,tors=2,hosts=4,aggs=2,up=2",
    "rail:tors=4,hosts=4,rails=4",
    "mesh:tors=4,hosts=4,planes=2",
    "clos3:pods=1,tors=1,hosts=2,aggs=1,up=1",
    "rail:tors=2,hosts=1,rails=1",
    "mesh:tors=1,hosts=4,planes=1",  # no mesh links at all
]


def table_topology(fabric: str):
    """The port's ``TableTopology`` of a fabric spec string."""
    from repro_torch.netsim import SimConfig
    from repro_torch.netsim.topogen import build_spec

    spec = build_spec(fabric)
    return Topology.build(SimConfig(n_hosts=spec.n_hosts, hosts_per_tor=spec.n_hosts,
                                    fabric=fabric))


def table_route_case(spec, seed, K=None, NP=700, NC=96, penalty=True):
    """``route_case`` for a generated fabric (its regions from the spec), and
    the reference form's per-arrival hosts and flags with garbage lanes:
    hosts and current queues outside the tables (the router clips them)."""
    rs = np.random.RandomState(seed)
    NQ, NH = spec.n_queues, spec.n_hosts
    K = K or NQ + NH
    H = max(NH // spec.n_tors, 1)
    conn_src = rs.randint(0, NH, size=NC)
    near = rs.rand(NC) < 0.3
    conn_dst = np.where(near, (conn_src // H) * H + rs.randint(0, H, size=NC),
                        rs.randint(0, NH, size=NC))
    pkt = np.zeros((PF, NP + 1), np.int32)
    pkt[PCONN] = rs.randint(0, NC, size=NP + 1)
    pkt[PEV] = rs.randint(0, 65536, size=NP + 1)
    pkt[PHOP] = rs.randint(1, 5, size=NP + 1)
    pkt[PCURQ] = rs.randint(0, NQ, size=NP + 1)
    edges = [q for r in spec.regions for q in (r.base, r.base + r.size - 1)]
    pkt[PCURQ, : len(edges)] = edges
    inj = rs.rand(NP + 1) < 0.3
    inj[: len(edges)] = False
    pkt[PHOP, inj] = 0
    pkt[PCURQ, inj] = -1
    a_idx = rs.randint(0, NP, size=K)
    a_idx[rs.rand(K) < 0.25] = NP
    a_idx[-min(5, K):] = NP
    a_idx[: min(K, len(edges))] = np.arange(min(K, len(edges)))
    q_len = rs.randint(0, 3, size=NQ)
    q_pen = np.where(rs.rand(NQ) < 0.15, 340, 0) if penalty else np.zeros(NQ, np.int64)
    # the reference form: each arrival's own flags and hosts, some garbage
    rows = pkt[:, a_idx.clip(max=NP - 1)]
    conn = rows[PCONN].clip(0, NC - 1)
    src, dst, cur = conn_src[conn], conn_dst[conn], rows[PCURQ].copy()
    junk = rs.rand(K) < 0.1
    src[junk] = rs.choice([-3, NH, NH + 9], size=int(junk.sum()))
    dst[rs.rand(K) < 0.1] = -2
    dst[rs.rand(K) < 0.05] = NH + 4
    cur[(rs.rand(K) < 0.1) & (rows[PHOP] > 0)] = NQ + 7
    i32 = lambda a: np.asarray(a, np.int32)
    return dict(pkt=pkt, a_idx=i32(a_idx), conn_src=i32(conn_src), conn_dst=i32(conn_dst),
                q_len=i32(q_len), q_pen=i32(q_pen), NP=NP, NC=NC, inj=rows[PHOP] == 0,
                cur=i32(cur), flow=i32(rows[PCONN]), ev=i32(rows[PEV]), src=i32(src),
                dst=i32(dst))


# ---------------------------------------------------------------------------
def test_seg_kernels_match_plain_versions(dev):
    rs = np.random.RandomState(0)
    for F, K, S in [(5, 128, 387), (2, 300, 129), (5, 128, 20000)]:
        seg = rs.randint(-1, S + 2, size=K).astype(np.int32)
        vals = rs.randint(-3, 60, size=(F, K)).astype(np.int32)
        assert torch.equal(ops.seg_sum(_on(dev, seg), _on(dev, vals), S),
                           ref.seg_sum_ref(_on(dev, seg), _on(dev, vals), S))
    for K, S in [(128, 129), (1000, 70000), (77, 3)]:
        seg = rs.randint(-1, S + 2, size=K).astype(np.int32)
        assert torch.equal(ops.seg_rank(_on(dev, seg), S), ref.seg_rank_ref(_on(dev, seg), S))


def test_reps_and_queue_kernels_match_plain_versions(dev):
    rs = np.random.RandomState(1)
    N = 300
    state = [rs.randint(0, 65536, size=(N, 8)).astype(np.int32), rs.rand(N, 8) < 0.5,
             rs.randint(0, 8, size=N).astype(np.int32), rs.randint(0, 9, size=N).astype(np.int32),
             rs.randint(0, 3, size=N).astype(np.int32), rs.rand(N) < 0.3,
             rs.randint(0, 3000, size=N).astype(np.int32), rs.randint(0, 3, size=N).astype(np.int32)]
    events = [rs.rand(N) < 0.5, rs.randint(0, 65536, size=N).astype(np.int32), rs.rand(N) < 0.3,
              rs.rand(N) < 0.2, rs.rand(N) < 0.6, rs.randint(0, 65536, size=N).astype(np.int32)]
    args = [_on(dev, a) for a in state + events] + [1234, 32, 800]
    for x, y in zip(ops.reps_tick(*args), ref.reps_tick_ref(*args)):
        assert torch.equal(x, y)
    tgt = rs.randint(0, 20, size=512).astype(np.int32)
    qlen = rs.randint(0, 86, size=384).astype(np.int32)
    u = rs.rand(512).astype(np.float32)
    serve = _on(dev, rs.rand(384) < 0.5)
    for sv in (None, serve):
        got = ops.queue_tick(_on(dev, tgt), _on(dev, u), _on(dev, qlen), sv, 85, 17, 68)
        want = ref.queue_tick_ref(_on(dev, tgt), _on(dev, u), _on(dev, qlen), sv, 85, 17, 68)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def _queue_case(rs, dev, B, K, Q, cap=85):
    """Busy queues near capacity (tail drops in later tiles), padding and
    negative targets, a row axis when B > 1."""
    shape, qshape = ((B, K), (B, Q)) if B > 1 else ((K,), (Q,))
    hot = rs.randint(0, Q, size=min(Q, 6))
    tgt = np.where(rs.rand(*shape) < 0.6, hot[rs.randint(0, len(hot), size=shape)],
                   rs.randint(0, Q, size=shape))
    tgt[rs.rand(*shape) < 0.3] = Q
    tgt[rs.rand(*shape) < 0.02] = -2
    qlen = rs.randint(0, cap + 1, size=qshape)
    qlen[..., hot] = cap - rs.randint(0, 40, size=len(hot))
    u = rs.rand(*shape).astype(np.float32)
    q_head = rs.randint(0, 4 * cap, size=qshape).astype(np.int32)
    return (_on(dev, tgt.astype(np.int32)), _on(dev, u), _on(dev, qlen.astype(np.int32)),
            _on(dev, rs.rand(*qshape) < 0.5), _on(dev, q_head))


@pytest.mark.parametrize("K", [300, 512, 2048])
def test_queue_tick_forms_match_plain_version(dev, K):
    """Both forms — the TPU kernel's and the engine's (its RED mark and ring
    slot) — against the plain version: Q = 20 and 384 in shared memory,
    Q = 12000 in the global scratch row, one row and a row axis."""
    rs = np.random.RandomState(K)
    rcp = float(np.float32(1.0) / np.float32(51))
    for B, Q in [(1, 20), (1, 384), (3, 384), (2, 20), (1, 12000), (2, 12000)]:
        tgt, u, qlen, serve, q_head = _queue_case(rs, dev, B, K, Q)
        for sv in (None, serve):
            args = (tgt, u, qlen, sv, 85, 17, 68)
            got = ops.queue_tick(*args)
            want = ref.queue_tick_ref(*args)
            assert len(got) == 4
            for x, y in zip(got, want, strict=True):
                assert torch.equal(x, y), (B, Q, sv is None)
            for pmax in (1.0, 0.5):
                kw = dict(red_rcp=rcp, pmax=pmax, q_head=q_head, qcap=85)
                got = ops.queue_tick(*args, **kw)
                want = ref.queue_tick_ref(*args, **kw)
                assert len(got) == 5
                for x, y in zip(got, want, strict=True):
                    assert torch.equal(x, y), (B, Q, sv is None, pmax)


def test_seg_rank_edge_cases_match_plain_version(dev):
    """Many passes (K = 4096), one repeated key, all ids out of range, a row
    axis, and S past the count table (warp turns on a shared and on a
    global histogram)."""
    rs = np.random.RandomState(4)
    cases = [(np.where(rs.rand(4096) < 0.25, 50, rs.randint(0, 7, size=4096)), 50),
             (np.full(1000, 3), 129), (np.full(4096, 0), 1),
             (np.where(rs.rand(1000) < 0.5, 129, -1), 129),
             (rs.randint(-1, 60, size=(3, 2500)), 57), (rs.randint(0, 40, size=(2, 128)), 129),
             (rs.randint(0, 5000, size=1000), 5000), (rs.randint(0, 70000, size=300), 70000)]
    for seg, S in cases:
        seg = _on(dev, seg.astype(np.int32))
        assert torch.equal(ops.seg_rank(seg, S), ref.seg_rank_ref(seg, S)), (tuple(seg.shape), S)


def test_queue_and_rank_wrappers_raise(dev):
    tgt, u, qlen, serve, q_head = _queue_case(np.random.RandomState(5), dev, 1, 300, 20)
    with pytest.raises(ValueError, match="u must be"):
        ops.queue_tick(tgt, u.double(), qlen, None, 85, 17, 68)
    with pytest.raises(ValueError, match="target must be"):
        ops.queue_tick(tgt.long(), u, qlen, None, 85, 17, 68)
    with pytest.raises(ValueError, match="u must be"):
        ops.queue_tick(tgt, u[:-1], qlen, None, 85, 17, 68)
    with pytest.raises(ValueError, match="serve must be"):
        ops.queue_tick(tgt, u, qlen, serve[:-1], 85, 17, 68)
    with pytest.raises(ValueError, match="q_head must be"):
        ops.queue_tick(tgt, u, qlen, None, 85, 17, 68, q_head=q_head.long(), qcap=85)
    with pytest.raises(ValueError, match="qcap"):
        ops.queue_tick(tgt, u, qlen, None, 85, 17, 68, q_head=q_head)
    with pytest.raises(ValueError, match="seg must be"):
        ops.seg_rank(tgt.long(), 20)
    with pytest.raises(ValueError, match="seg must be"):
        ops.seg_rank(tgt[None, None], 20)


def test_seg_sum_field_sequence_matches_plain_version(dev):
    """Fields as they are (bool and int32 mixed, contiguous views with an
    offset among them), one row and with a row axis."""
    rs = np.random.RandomState(3)
    for kinds, B, K, S in [("ibiii", 1, 128, 387), ("bb", 1, 128, 129), ("bbbb", 1, 96, 129),
                           ("ibiiibbi", 3, 300, 40), ("b", 2, 1000, 20000), ("i", 1, 1, 1),
                           ("bi", 2, 500, 40000)]:  # past shared memory: global atomics
        shape = (B, K) if B > 1 else (K,)
        seg = _on(dev, rs.randint(-1, S + 2, size=shape).astype(np.int32))
        fields = []
        for k in kinds:
            pad = rs.rand(B * K + 3) < 0.4 if k == "b" else rs.randint(-3, 60, size=B * K + 3)
            fields.append(_on(dev, pad.astype(bool if k == "b" else np.int32))[3:].view(shape))
        got = ops.seg_sum(seg, fields, S)
        assert torch.equal(got, ref.seg_sum_ref(seg, fields, S))
        stacked = torch.stack([f.to(torch.int32) for f in fields], dim=-2)
        assert torch.equal(got, ops.seg_sum(seg, stacked, S))


@pytest.mark.parametrize("R", [2, 4])
def test_reps_tick_rounds_match_plain_version(dev, R):
    rs = np.random.RandomState(R)
    for shape, absent in [((128,), ()), ((3, 128), ()), ((300,), ("ecn", "timeout")),
                          ((128,), ("ev", "send", "rand"))]:
        n = int(np.prod(shape))
        b = lambda p: _on(dev, rs.rand(n) < p).view(shape)
        i = lambda hi: _on(dev, rs.randint(0, hi, size=n).astype(np.int32)).view(shape)
        state = [_on(dev, rs.randint(0, 65536, size=(*shape, 8)).astype(np.int32)),
                 _on(dev, rs.rand(*shape, 8) < 0.5), i(8), i(9), i(3), b(0.3), i(3000), i(3)]
        masks = tuple(b(0.6) for _ in range(R))
        evs = None if "ev" in absent else tuple(i(65536) for _ in range(R))
        ecns = None if "ecn" in absent else tuple(b(0.3) for _ in range(R))
        events = [masks, evs, ecns, None if "timeout" in absent else b(0.3),
                  None if "send" in absent else b(0.6), None if "rand" in absent else i(65536)]
        args = state + events + [1500, 32, 800]
        for x, y in zip(ops.reps_tick(*args), ref.reps_tick_ref(*args)):
            assert torch.equal(x, y)
    too_many = (masks[0],) * 5
    with pytest.raises(ValueError, match="at most 4"):
        ops.reps_tick(*state, too_many, None, None, None, None, None, 1500, 32, 800)
    ring = _on(dev, np.zeros(n * 8 + 1, np.int32))[1:].view(*shape, 8)  # only 4-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        ops.reps_tick(ring, *state[1:], *events, 1500, 32, 800)


def test_ecmp_hash_kernel_matches_plain_version(dev):
    rs = np.random.RandomState(2)
    for shape, nports in [((512,), 16), ((1000,), 13), ((3, 384), 4), ((77,), 1)]:
        flow = rs.randint(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ev = rs.randint(0, 65536, size=shape).astype(np.int32)
        salt = (2**31 - 1 - rs.randint(0, 9000, size=shape)).astype(np.int32)
        args = [_on(dev, a) for a in (flow, ev, salt)]
        assert torch.equal(ops.ecmp_hash(*args, nports), ref.ecmp_hash_ref(*args, nports))
    with pytest.raises(ValueError, match="nports >= 1"):
        ops.ecmp_hash(*args, 0)


def test_ecmp_hash_kernel_per_lane_nports_matches_plain_version(dev):
    """One port count per lane (1..16, lanes at 1 included), as a (K,) or
    (B, K) tensor, broadcast over rows and one per row: kernel == plain
    version."""
    rs = np.random.RandomState(5)
    for shape, lanes in [((512,), (512,)), ((3, 384), (3, 384)), ((4, 200), (200,)),
                         ((77,), (77,)), ((5, 200), (5, 1))]:
        flow = rs.randint(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ev = rs.randint(0, 65536, size=shape).astype(np.int32)
        salt = (2**31 - 1 - rs.randint(0, 9000, size=shape)).astype(np.int32)
        nports = rs.randint(1, 17, size=lanes).astype(np.int32)
        nports.reshape(-1)[::7] = 1
        args = [_on(dev, a) for a in (flow, ev, salt, nports)]
        got = ops.ecmp_hash(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.ecmp_hash_ref(*args)), shape
    with pytest.raises(ValueError, match="int32"):
        ops.ecmp_hash(*args[:3], args[3].long())


@pytest.mark.parametrize("tiers", [2, 3])
def test_next_queue_kernel_rows_match_plain_version(dev, tiers):
    """A fleet's arrivals (B, K) in one launch, both forms, adaptive on and
    off, penalty shared and per row: kernel == plain version == B one-row
    kernel calls."""
    name, kw = ROUTE_FABRICS[tiers][0]
    topo = Topology.build(getattr(presets, name).replace(**kw))
    g, B = topo.geometry, 5
    cases = [route_case(topo, 300 + 10 * tiers + b) for b in range(B)]
    src, dst = (_on(dev, cases[0][k]) for k in ("conn_src", "conn_dst"))
    NP = cases[0]["NP"]
    rows = [c["pkt"][:, c["a_idx"].clip(max=NP - 1)] for c in cases]
    fields = [_on(dev, np.stack([r[f] for r in rows])) for f in (PHOP, PCURQ, PCONN, PEV)]
    a_idx = _on(dev, np.stack([c["a_idx"] for c in cases]))
    q_len = _on(dev, np.stack([c["q_len"] for c in cases]))
    conn = fields[2].clamp(0, cases[0]["NC"] - 1)
    flat = [fields[0] == 0, fields[1], fields[2], fields[3], src[conn].contiguous(),
            dst[conn].contiguous()]
    for pen in (_on(dev, cases[0]["q_pen"]), _on(dev, np.stack([c["q_pen"] for c in cases])),
                None):
        for adaptive in (False, True):
            engine = (g, *fields, src, dst, q_len, adaptive, pen, a_idx, NP)
            reference = (g, *flat, q_len, adaptive, pen)
            for args in (engine, reference):
                got = ops.next_queue(*args)
                torch.cuda.synchronize()
                assert torch.equal(got, ref.next_queue_ref(*args)), (name, adaptive)
                for b in range(B):  # one row's call: (B, ...) inputs sliced, shared kept
                    one = [x[b].contiguous() if isinstance(x, torch.Tensor) and x.dim() == 2
                           else x for x in args]
                    assert torch.equal(got[b], ops.next_queue(*one)), (name, adaptive, b)


@pytest.mark.parametrize("tiers", [2, 3])
def test_next_queue_kernel_per_row_tables_match_plain_version(dev, tiers):
    """The engine form with one connection table pair per row ``(B, NC)``
    (contiguous, or one row expanded: row stride 0), adaptive on and off,
    penalty shared, per row and expanded: kernel == plain version == B
    one-row kernel calls, each with its row's tables."""
    name, kw = ROUTE_FABRICS[tiers][0]
    topo = Topology.build(getattr(presets, name).replace(**kw))
    g, B = topo.geometry, 4
    cases = [route_case(topo, 500 + 10 * tiers + b) for b in range(B)]
    NP = cases[0]["NP"]
    rows = [c["pkt"][:, c["a_idx"].clip(max=NP - 1)] for c in cases]
    fields = [_on(dev, np.stack([r[f] for r in rows])) for f in (PHOP, PCURQ, PCONN, PEV)]
    stack = lambda k: _on(dev, np.stack([c[k] for c in cases]))
    a_idx, q_len, src, dst = (stack(k) for k in ("a_idx", "q_len", "conn_src", "conn_dst"))
    tables = [(src, dst), (src[1].expand(B, -1), dst[1].expand(B, -1))]
    pens = (_on(dev, cases[0]["q_pen"]), stack("q_pen"), stack("q_pen")[2].expand(B, -1))
    for (src, dst), pen in ((t, p) for t in tables for p in pens):
        for adaptive in (False, True):
            args = (g, *fields, src, dst, q_len, adaptive, pen, a_idx, NP)
            got = ops.next_queue(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.next_queue_ref(*args)), (name, adaptive)
            for b in range(B):
                one = [x[b].contiguous() if isinstance(x, torch.Tensor) and x.dim() == 2 else x
                       for x in args]
                assert torch.equal(got[b], ops.next_queue(*one)), (name, adaptive, b)


@pytest.mark.parametrize("tiers", [2, 3])
def test_next_queue_kernel_matches_plain_version(dev, tiers):
    """Both forms on every routing case, and the engine's shapes, with and
    without adaptive routing and the penalty: kernel == plain version."""
    for name, kw in ROUTE_FABRICS[tiers]:
        topo = Topology.build(getattr(presets, name).replace(**kw))
        g = topo.geometry
        for seed in range(3):
            c = {k: _on(dev, v) if isinstance(v, np.ndarray) else v
                 for k, v in route_case(topo, 100 * tiers + seed, penalty=seed != 1).items()}
            A = c["pkt"][:, c["a_idx"].clamp(max=c["NP"] - 1)]
            rows = (A[PHOP], A[PCURQ], A[PCONN], A[PEV])
            cc = A[PCONN].clamp(0, c["NC"] - 1)
            flat = (A[PHOP] == 0, A[PCURQ], A[PCONN], A[PEV], c["conn_src"][cc], c["conn_dst"][cc])
            for adaptive in (False, True):
                pen = c["q_pen"] if seed != 2 else None
                engine = (g, *rows, c["conn_src"], c["conn_dst"], c["q_len"], adaptive, pen,
                          c["a_idx"], c["NP"])
                reference = (g, *[t.contiguous() for t in flat], c["q_len"], adaptive, pen)
                for args in (engine, reference):
                    got = ops.next_queue(*args)
                    torch.cuda.synchronize()
                    assert torch.equal(got, ref.next_queue_ref(*args)), (name, seed, adaptive)


def test_next_queue_wrapper_raises(dev):
    topo = Topology.build(presets.FATTREE_128_3T)
    g, q = topo.geometry, _on(dev, np.zeros(8, np.int32))
    q_len = _on(dev, np.zeros(topo.n_queues, np.int32))
    with pytest.raises(ValueError, match="bool"):  # the reference form takes bool flags
        ops.next_queue(g, q, q, q, q, q, q, q_len, False)
    with pytest.raises(ValueError, match="connection tables"):
        ops.next_queue(g, q, q, q, q, q[:0], q[:0], q_len, False, a_idx=q, n_pkt=8)
    with pytest.raises(ValueError, match="q_len"):
        ops.next_queue(g, q == 0, q, q, q, q, q, q, True)
    with pytest.raises(ValueError, match="agg_uplinks"):
        ops.next_queue(g._replace(agg_uplinks=0), q == 0, q, q, q, q, q, q_len, False)
    q2 = _on(dev, np.zeros((2, 8), np.int32))
    q_len2 = _on(dev, np.zeros((2, topo.n_queues), np.int32))
    strided = _on(dev, np.zeros((2, 16), np.int32))[:, ::2]  # column stride 2
    with pytest.raises(ValueError, match="row stride"):
        ops.next_queue(g, q2, q2, q2, q2, strided, strided, q_len2, False, a_idx=q2, n_pkt=8)


@pytest.mark.parametrize("lbn", ["reps", "mprdma", "mixed"])
def test_fleet_card_run_equals_cpu_run(dev, lbn):
    """A small fleet (3 seeds) on the card == on the CPU, every leaf of every
    row; each kernel's launches per tick are those of one run."""
    from repro_torch.netsim import FleetRunner

    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    kw = dict(evs_size=cfg.evs_size)
    if lbn == "mixed":
        kw.update(fg="reps", bg="plb", bg_conns=(1, 4, 9, 20))
    finals = []
    for d in (dev, "cpu"):
        fleet = FleetRunner(cfg, workloads.permutation(32, 48, seed=3), make_lb(lbn, **kw),
                            failures=failures.link_down(ups, 30, 300), seeds=(0, 5, 9),
                            device=d)
        ops.reset_launch_counts()
        states, _ = fleet.run(400)
        counts = ops.launch_counts()
        finals.append([sim_state_to_numpy(fleet.state_at(states, i)) for i in range(3)])
        if d == dev:
            assert counts["seg_sum"] == 4 * 400 and counts["queue_tick"] == 400, counts
            assert counts["next_queue"] == 400 and counts["seg_rank"] == 400, counts
            assert counts["reps_tick"] == (0 if lbn == "mprdma" else 400), counts
    for a, b in zip(*finals):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("lbn", ["reps", "adaptive_roce"])
def test_three_tier_card_run_equals_cpu_run(dev, lbn):
    """The 3-tier fabric of tests/test_torch_three_tier.py with one agg
    uplink down: card == CPU on every leaf, one routing launch per tick."""
    cfg = FATTREE_32_CI.replace(hosts_per_tor=4, tiers=3, tors_per_pod=2, aggs_per_pod=4,
                                agg_uplinks=2, rto_ticks=500, max_msg_pkts=256)
    down = Topology.build(cfg).agg_up_base
    kw = dict(evs_size=256, **(dict(freezing_timeout=200) if lbn == "reps" else {}))
    finals = []
    for d in (dev, "cpu"):
        sim = Simulator(cfg, workloads.permutation(32, 48, seed=3), make_lb(lbn, **kw),
                        failures=failures.link_down([down], 30, 600), device=d)
        ops.reset_launch_counts()
        state, _ = sim.run(700)
        counts = ops.launch_counts()
        finals.append(sim_state_to_numpy(state))
        if d == dev:
            assert counts["next_queue"] == 700 and counts["ecmp_hash"] == 0, counts
    for k in finals[0]:
        assert finals[0][k].tobytes() == finals[1][k].tobytes(), k


@pytest.mark.parametrize("lbn", ["ops", "reps", "plb", "bitmap", "mixed", "adaptive_roce"])
def test_card_run_equals_cpu_run(dev, lbn):
    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    kw = dict(evs_size=cfg.evs_size)
    if lbn == "reps":
        kw.update(freezing_timeout=200)
    if lbn == "mixed":
        kw.update(fg="reps", bg="plb", bg_conns=(1, 4, 9, 20))
    finals = []
    for d in (dev, "cpu"):
        sim = Simulator(cfg, workloads.permutation(32, 48, seed=3), make_lb(lbn, **kw),
                        failures=failures.link_down(ups, 30, 300), device=d)
        ops.reset_launch_counts()
        state, _ = sim.run(470)
        counts = ops.launch_counts()
        finals.append(sim_state_to_numpy(state))
        if d == dev:
            assert counts["seg_sum"] == 4 * 470 and counts["queue_tick"] == 470
            # one routing launch per tick for every LB, adaptive RoCE's
            # least-loaded pick included; the hash is inside it
            assert counts["next_queue"] == 470 and counts["ecmp_hash"] == 0
            # one fused REPS launch per tick (both ACK rounds, timeouts, sends)
            assert counts["reps_tick"] == (470 if lbn in ("reps", "mixed") else 0)
    for k in finals[0]:
        assert finals[0][k].tobytes() == finals[1][k].tobytes(), k


def test_fleet_run_summary_with_own_scenarios_card_equals_cpu(dev):
    """Three FATTREE_32_CI rows, each its own workload, failure schedule
    (down, degraded, gray loss) and watch list, through ``run_summary`` with
    the default spec and two cohorts: the card's carry and every leaf equal
    the CPU's; seg_sum launches 4 + 4 times per tick (one per histogram)."""
    from repro_torch.netsim import (
        FailureSchedule, FleetRunner, TelemetrySpec, Workload, stack_scenarios,
    )

    cfg = FATTREE_32_CI.replace(msg_slots=64, conns_per_host=2, failure_slots=4)
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)]
    rs = np.random.RandomState(1)
    hosts = np.arange(32, dtype=np.int32)
    none = np.full(32, -1, np.int32)
    wls = [Workload(hosts, (hosts + k) % 32, rs.randint(8, 49, 32).astype(np.int32),
                    rs.randint(0, 40 * k, 32).astype(np.int32), none) for k in (3, 11, 16)]
    fss = [failures.link_down(ups[:2], 40, failures.FOREVER),
           FailureSchedule.concat(failures.link_degraded([ups[2]], 10, 300),
                                  failures.link_down([ups[4]], 80, 200)),
           failures.gray_loss([ups[1], ups[6]], 5, 350, 0.25)]
    watch = [ups[:4], ups[4:8], [ups[0], ups[3], 5, 9]]
    spec = TelemetrySpec.default().with_cohorts({"a": range(0, 32, 3), "b": range(1, 32, 3)})
    out = []
    for d in (dev, "cpu"):
        sims = [Simulator(cfg, w, make_lb("reps", evs_size=cfg.evs_size), failures=f,
                          watch_queues=q, device=d) for w, f, q in zip(wls, fss, watch)]
        fleet = FleetRunner(cfg, wls[0], sims[0].lb, failures=fss[0], watch_queues=watch[0],
                            seeds=(0, 5, 9), device=d)
        ops.reset_launch_counts()
        states, tel = fleet.run_summary(400, spec, scn=stack_scenarios([s.scn for s in sims]))
        counts = ops.launch_counts()
        if d == dev:
            assert counts["seg_sum"] == 8 * 400 and counts["next_queue"] == 400, counts
        out.append((tel.tel, [sim_state_to_numpy(fleet.state_at(states, i)) for i in range(3)]))
    (tel_g, rows_g), (tel_c, rows_c) = out
    assert tel_g.tobytes() == tel_c.tobytes()
    for a, b in zip(rows_g, rows_c):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    assert all(r["s_stats"][1] > 0 for r in rows_c)  # every row's failures drop packets


def test_alternating_own_scenarios_do_not_synchronize(dev):
    """Two stacked rows' scenarios, alternated tick by tick as a sweep over
    buckets does: after each has been prepared, a window of ticks in which
    no failure window opens or closes makes no device-to-host copy and no
    synchronize inside an op (the tables are prepared once per scenario,
    not at every switch)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import FleetRunner, stack_scenarios

    cfg = FATTREE_32_CI.replace(msg_slots=64, conns_per_host=2, failure_slots=4)
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)]
    wls = [workloads.permutation(32, 48, seed=s) for s in (3, 4, 5)]
    fss = [failures.link_down(ups[:2], 20, failures.FOREVER),
           failures.link_degraded([ups[2]], 10, 300),
           failures.gray_loss([ups[1]], 5, 300, 0.25)]
    sims = [Simulator(cfg, w, make_lb("reps", evs_size=cfg.evs_size), failures=f,
                      watch_queues=ups[:4], device=dev) for w, f in zip(wls, fss)]
    scns = [stack_scenarios([s.scn for s in sims]),
            stack_scenarios([sims[i].scn for i in (2, 0, 1)])]
    fleet = FleetRunner(cfg, wls[0], sims[0].lb, failures=fss[0], watch_queues=ups[:4],
                        seeds=(0, 5, 9), device=dev)
    sim, states = fleet.sim, fleet.init_states()
    draws = sim.tick_draws(fleet.base_keys(), 0, 100, scns[0])
    for t in range(60):
        states, _ = sim.step_rows(states, t, draws.row(t), scns[t % 2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(60, 100):
            states, _ = sim.step_rows(states, t, draws.row(t), scns[t % 2])
        torch.cuda.synchronize()
    # the window's closing synchronize (and the profiler's own) are top-level
    # device synchronizes; a tick's would be inside an op
    top = lambda e: e.cpu_parent is None and e.name == "cudaDeviceSynchronize"
    bad = [e.name for e in prof.events()
           if "DtoH" in e.name or "DeviceToHost" in e.name
           or ("Synchronize" in e.name and not top(e))]
    assert not bad, bad[:5]


def test_sweep_switch_bucket_one_reps_launch_per_tick_card_equals_cpu(dev):
    """A sweep bucket whose SwitchLB runs REPS on one row of four (ECMP,
    OPS and a second OPS seed beside it) and a horizon-merged row: each
    kernel is one launch per tick (``reps_tick`` 1, ``seg_sum`` 4 +
    histograms in summary mode), and every row and telemetry carry equals
    the CPU sweep's."""
    from repro_torch.netsim import SweepCase, SweepEngine, TelemetrySpec

    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    fs = failures.link_down(ups, 40, failures.FOREVER)
    wl = workloads.permutation(32, 40, seed=2)
    kw = dict(evs_size=cfg.evs_size)
    cases = [SweepCase("e", wl, "ecmp", 300, kw, fs), SweepCase("o", wl, "ops", 200, kw, fs,
                                                               seeds=(0, 4)),
             SweepCase("r", wl, "reps", 300, dict(kw, freezing_timeout=100), fs)]
    out = {}
    for d in (dev, "cpu"):
        eng = SweepEngine(cfg, cases, device=d)
        assert len(eng.buckets) == 1 and eng.buckets[0].program.masked
        if d == dev:
            ops.reset_launch_counts()
        out[d] = (eng, eng.run(collect="summary", chunk=150))
        if d == dev:
            counts = ops.launch_counts()
    n_hist = sum(type(c).__name__ == "Histogram" for c in TelemetrySpec.default().channels)
    want = {"reps_tick": 1, "next_queue": 1, "seg_rank": 1, "queue_tick": 1,
            "seg_sum": 4 + n_hist, "ecmp_hash": 0, "next_queue_table": 0}
    assert counts == {k: m * 300 for k, m in want.items()}, counts
    (_, gres), (_, cres) = out[dev], out["cpu"]
    assert np.array_equal(gres.buckets[0].telemetry, cres.buckets[0].telemetry)
    for c in cases:
        for si in range(len(c.seeds)):
            a = sim_state_to_numpy(gres.state_for(c.name, si))
            b = sim_state_to_numpy(cres.state_for(c.name, si))
            for k in a:
                assert a[k].tobytes() == b[k].tobytes(), (c.name, si, k)


@pytest.mark.parametrize("fabric", TABLE_FABRICS)
def test_next_queue_table_kernel_matches_plain_version(dev, fabric):
    """The table form on every fabric kind and corner: both forms, adaptive
    on and off, penalty or none, one run's arrivals and a fleet's rows
    (tables and penalty shared or per row): kernel == plain version == one-row
    launches."""
    topo = table_topology(fabric)
    t, B = topo.tables(dev), 4
    cases = [table_route_case(topo.spec, 40 + b) for b in range(B)]
    NP = cases[0]["NP"]
    stack = lambda k: _on(dev, np.stack([c[k] for c in cases]))
    rows = [c["pkt"][:, c["a_idx"].clip(max=NP - 1)] for c in cases]
    fields = [_on(dev, np.stack([r[f] for r in rows])) for f in (PHOP, PCURQ, PCONN, PEV)]
    a_idx, q_len = stack("a_idx"), stack("q_len")
    flat = [_on(dev, np.stack([c["inj"] for c in cases]))] + [
        stack(k) for k in ("cur", "flow", "ev", "src", "dst")]
    for pen in (_on(dev, cases[0]["q_pen"]), stack("q_pen"), None):
        for src, dst in ((_on(dev, cases[0]["conn_src"]), _on(dev, cases[0]["conn_dst"])),
                         (stack("conn_src"), stack("conn_dst"))):
            for adaptive in (False, True):
                engine = (t, *fields, src, dst, q_len, adaptive, pen, a_idx, NP)
                reference = (t, *flat, q_len, adaptive, pen)
                for args in (engine, reference):
                    got = ops.next_queue_table(*args)
                    torch.cuda.synchronize()
                    assert torch.equal(got, ref.next_queue_table_ref(*args)), (fabric, adaptive)
                    one = [x[0].contiguous() if isinstance(x, torch.Tensor) and x.dim() == 2
                           else x for x in args]
                    assert torch.equal(got[0], ops.next_queue_table(*one)), (fabric, adaptive)


def test_next_queue_table_wrapper_raises(dev):
    topo = table_topology(TABLE_FABRICS[1])
    t, q = topo.tables(dev), _on(dev, np.zeros(8, np.int32))
    q_len = _on(dev, np.zeros(topo.n_queues, np.int32))
    with pytest.raises(ValueError, match="bool"):
        ops.next_queue_table(t, q, q, q, q, q, q, q_len, False)
    with pytest.raises(ValueError, match="connection tables"):
        ops.next_queue_table(t, q, q, q, q, q[:0], q[:0], q_len, False, a_idx=q, n_pkt=8)
    with pytest.raises(ValueError, match="up_deg"):
        ops.next_queue_table(t._replace(up_deg=t.up_deg.long()), q == 0, q, q, q, q, q, q_len,
                             False)


@pytest.mark.parametrize("fabric,lbn", [("rail:tors=4,hosts=4,rails=4", "reps"),
                                        ("mesh:tors=4,hosts=4,planes=2", "adaptive_roce"),
                                        ("clos3:pods=2,tors=2,hosts=4,aggs=2,up=2", "reps")])
def test_generated_fabric_card_run_equals_cpu_run(dev, fabric, lbn):
    """A generated fabric on the card == on the CPU, every leaf; the table
    form launches once per tick, the arithmetic routing and the flat hash
    never."""
    from repro_torch.netsim import SimConfig

    cfg = SimConfig(n_hosts=16, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120,
                    evs_size=256, fabric=fabric)
    finals = []
    for d in (dev, "cpu"):
        sim = Simulator(cfg, workloads.permutation(16, 24, seed=3),
                        make_lb(lbn, evs_size=cfg.evs_size), seed=7, device=d)
        ops.reset_launch_counts()
        state, _ = sim.run(300)
        counts = ops.launch_counts()
        finals.append(sim_state_to_numpy(state))
        if d == dev:
            assert counts["next_queue_table"] == 300 and counts["next_queue"] == 0, counts
            assert counts["ecmp_hash"] == 0, counts
    for k in finals[0]:
        assert finals[0][k].tobytes() == finals[1][k].tobytes(), k


@pytest.mark.parametrize("B", [1, 2])
def test_kernels_at_scale_shapes_match_plain_versions(dev, B):
    """seg_sum (the feedback call: five fields, S = 3 (NC + 1)), seg_rank (S =
    NC + 1) and reps_tick (N = NC, two ACK rounds) at a scale-mode shape
    (NC = 2**17 connections, reduced from the 10**6 of chip_smoke.py):
    kernel == plain version, with the global-memory paths these S take."""
    rs = np.random.RandomState(B)
    NC, K = 2**17, 128
    S = 3 * (NC + 1)
    seg = rs.randint(0, S, size=(B, K)).astype(np.int32)
    seg[rs.rand(B, K) < 0.3] = S
    fields = [_on(dev, rs.randint(0, 9, size=(B, K)).astype(np.int32)), _on(dev, rs.rand(B, K) < 0.5)]
    fields += [_on(dev, rs.randint(0, 65536, size=(B, K)).astype(np.int32)),
               _on(dev, rs.rand(B, K) < 0.3), _on(dev, rs.randint(0, 900, size=(B, K)).astype(np.int32))]
    sq = (lambda x: x[0]) if B == 1 else (lambda x: x)
    got = ops.seg_sum(sq(_on(dev, seg)), [sq(f) for f in fields], S)
    assert torch.equal(got, ref.seg_sum_ref(sq(_on(dev, seg)), [sq(f) for f in fields], S))
    rk = rs.randint(0, NC + 1, size=(B, K)).astype(np.int32)
    rk[:, ::3] = NC  # the sentinel segment, many repeats
    assert torch.equal(ops.seg_rank(sq(_on(dev, rk)), NC + 1), ref.seg_rank_ref(sq(_on(dev, rk)), NC + 1))
    shape = (NC,) if B == 1 else (B, NC)
    n = B * NC
    r = lambda lo, hi: _on(dev, rs.randint(lo, hi, size=n).astype(np.int32).reshape(shape))
    b = lambda p: _on(dev, (rs.rand(n) < p).reshape(shape))
    state = [_on(dev, rs.randint(0, 65536, size=(n, 8)).astype(np.int32).reshape(*shape, 8)),
             _on(dev, (rs.rand(n, 8) < 0.5).reshape(*shape, 8)), r(0, 8), r(0, 9), r(0, 3), b(0.3),
             r(0, 3000), r(0, 3)]
    acks = [(b(0.5), r(0, 65536), b(0.3)) for _ in range(2)]
    ev = [tuple(a[c] for a in acks) for c in range(3)] + [b(0.2), b(0.6), r(0, 65536)]
    for x, y in zip(ops.reps_tick(*state, *ev, 1234, 32, 800),
                    ref.reps_tick_ref(*state, *ev, 1234, 32, 800)):
        assert torch.equal(x, y)


def test_scale_mode_card_run_equals_cpu_run(dev):
    """The sparse active-set engine on the card == on the CPU, every leaf,
    with a binding active_slots cap (alloc failures counted)."""
    from repro_torch.netsim import SimConfig

    for active in (0, 64):
        cfg = SimConfig(n_hosts=16, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120,
                        conn_sharding=True, active_slots=active)
        finals = []
        for d in (dev, "cpu"):
            sim = Simulator(cfg, workloads.permutation(16, 24, seed=3),
                            make_lb("reps", evs_size=cfg.evs_size), seed=7, device=d)
            state, _ = sim.run(300)
            finals.append(sim_state_to_numpy(state))
        for k in finals[0]:
            assert finals[0][k].tobytes() == finals[1][k].tobytes(), (active, k)


@pytest.mark.parametrize("rows", [1, 3, 7])
def test_traced_reps_tick_matches_plain_version(dev, rows):
    """The traced form (``trace_rows``): the same state outputs as the
    untraced launch and as the plain version, and per-row counts equal to
    the plain version's; rows of 1, 20 and 128 connections (rows sharing a
    warp and a block), every event class, and without the timeout class."""
    rs = np.random.RandomState(11 + rows)
    for per_row, timeout in [(128, True), (20, True), (1, True), (300, False)]:
        n = rows * per_row
        b = lambda p: _on(dev, rs.rand(n) < p)
        i = lambda hi: _on(dev, rs.randint(0, hi, size=n).astype(np.int32))
        state = [_on(dev, rs.randint(0, 65536, size=(n, 8)).astype(np.int32)),
                 _on(dev, rs.rand(n, 8) < 0.5), i(8), i(9), i(3), b(0.3), i(3000), i(3)]
        args = state + [(b(0.6), b(0.5)), (i(65536), i(65536)), (b(0.3), b(0.3)),
                        b(0.4) if timeout else None, b(0.7), i(65536), 1500, 32, 800]
        untraced = ops.reps_tick(*args)
        traced = ops.reps_tick(*args, trace_rows=rows)
        plain = ref.reps_tick_ref(*[a.cpu() if isinstance(a, torch.Tensor) else
                                    tuple(x.cpu() for x in a) if isinstance(a, tuple) else a
                                    for a in args], trace_rows=rows)
        assert len(traced) == len(untraced) + 1 == len(plain)
        for x, y, z in zip(untraced, traced, plain):
            assert torch.equal(x, y) and torch.equal(y.cpu(), z)
        assert torch.equal(traced[-1].cpu(), plain[-1])
        assert int(plain[-1][:, :3].sum()) > 0
    with pytest.raises(ValueError, match="rows"):
        ops.reps_tick(*args, trace_rows=7 * n + 1)


def test_traced_sweep_card_equals_cpu_one_reps_launch_per_tick(dev):
    """A traced sweep bucket (SwitchLB ECMP/OPS/REPS, a failure, a
    horizon-merged row): every ring, state and telemetry carry equals the
    CPU sweep's, and ``reps_tick`` stays one launch per tick."""
    from repro_torch.netsim import SweepCase, SweepEngine
    from repro_torch.netsim.tracer import TraceSpec

    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    fs = failures.link_down(ups, 40, failures.FOREVER)
    wl = workloads.permutation(32, 40, seed=2)
    kw = dict(evs_size=cfg.evs_size)
    cases = [SweepCase("e", wl, "ecmp", 300, kw, fs), SweepCase("o", wl, "ops", 200, kw, fs),
             SweepCase("r", wl, "reps", 300, dict(kw, freezing_timeout=100), fs)]
    out = {}
    for d in (dev, "cpu"):
        eng = SweepEngine(cfg, cases, device=d)
        if d == dev:
            ops.reset_launch_counts()
        out[d] = eng.run(collect="summary", chunk=150, trace=TraceSpec(ring=512))
        if d == dev:
            counts = ops.launch_counts()
    assert counts["reps_tick"] == 300, counts
    g, c = out[dev].buckets[0], out["cpu"].buckets[0]
    assert np.array_equal(g.trace_rows, c.trace_rows)
    assert np.array_equal(g.telemetry, c.telemetry)
    for name in ("e", "o", "r"):
        a, b = sim_state_to_numpy(out[dev].state_for(name)), sim_state_to_numpy(
            out["cpu"].state_for(name))
        assert all(a[k].tobytes() == b[k].tobytes() for k in a), name
    assert out[dev].flight_for("r")["cursor"] > 0


def test_balls_bins_card_equals_cpu(dev):
    """The three balls-into-bins models on the card (seg_rank / seg_sum
    kernels) against the CPU (their plain versions), every output."""
    from repro_torch import rng
    from repro_torch.core import balls_bins as bb

    key = lambda d: rng.PRNGKey(3, d)
    for n, b, tau, steps, cap, co in [(8, 5, 8, 300, 0, 1), (32, 9, 13, 400, 16, 2),
                                      (128, 12, 19, 200, 0, 1)]:
        g = bb.simulate_recycled_bins(key(dev), n, b, tau, steps, cap, co)
        c = bb.simulate_recycled_bins(key("cpu"), n, b, tau, steps, cap, co, device="cpu")
        for x, y in zip(g, c):
            assert x.device.type == "cuda" and torch.equal(x.cpu(), y)
    for n, lam in [(8, 0.99), (128, 0.5)]:
        assert torch.equal(bb.simulate_ops_bins(key(dev), n, lam, 500).cpu(),
                           bb.simulate_ops_bins(key("cpu"), n, lam, 500, device="cpu"))
    assert torch.equal(bb.evs_load_imbalance(key(dev), 32, 2**12, 32, 5).cpu(),
                       bb.evs_load_imbalance(key("cpu"), 32, 2**12, 32, 5, device="cpu"))
