"""The port's fabric generator and table router against the reference's.

``repro_torch.netsim.topogen`` is a numpy-only copy of
``repro.netsim.topogen``: for the same spec strings (hypothesis draws the
parameters the reference's tests/test_topogen.py draws) every
``TopologySpec`` array, region, diameter and ``walk`` route is equal, and
the parse and build errors carry the same messages.  The port's
``TableTopology`` routes (``next_queue`` in the reference's form, ``route``
in the engine's, both through ``ops.next_queue_table``: on CPU tensors its
plain version) equal the reference's ``TableTopology.next_queue`` and the
JAX engine's arrivals sequence bit for bit (tolerance 0), on every fabric
kind and degenerate corner, with garbage lanes, adaptive routing over tied
queue lengths and a failed-port penalty.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the shim keeps the property bodies live without hypothesis
    from _hypothesis_fallback import given, settings, st

from repro.netsim import topogen as jgen
from repro.netsim import topology as jtopo
from repro.netsim.config import SimConfig as JConfig
from repro.netsim.engine import PCONN, PCURQ, PEV, PHOP
from repro_torch.netsim import interop, topogen as tgen
from test_torch_cuda import TABLE_FABRICS, table_route_case, table_topology

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

CLOS3 = st.tuples(*(st.integers(1, 3) for _ in range(5)))
RAIL = st.tuples(st.integers(1, 4), st.integers(1, 4), st.integers(1, 4))
MESH = st.tuples(st.integers(1, 4), st.integers(1, 3), st.integers(1, 3))


def _strings(clos, rail, mesh):
    p, t, h, a, u = clos
    return [
        tgen.fabric_str("clos3", pods=p, tors=t, hosts=h, aggs=a, up=u),
        tgen.fabric_str("rail", tors=rail[0], hosts=rail[1], rails=rail[2]),
        tgen.fabric_str("mesh", tors=mesh[0], hosts=mesh[1], planes=mesh[2]),
    ]


def _same_spec(s: str) -> tuple:
    js, ts = jgen.build_spec(s), tgen.build_spec(s)
    a, b = interop.topology_spec_to_numpy(js), interop.topology_spec_to_numpy(ts)
    assert a.keys() == b.keys()
    for f in a:
        x, y = a[f], b[f]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (s, f)
        else:
            assert x == y, (s, f)
    return js, ts


@settings(max_examples=25, deadline=None)
@given(CLOS3, RAIL, MESH)
def test_specs_equal_reference(clos, rail, mesh):
    for s in _strings(clos, rail, mesh):
        assert jgen.fabric_str(*jgen.parse_fabric(s)[:1], **jgen.parse_fabric(s)[1]) == s
        assert tgen.parse_fabric(s) == jgen.parse_fabric(s)
        _same_spec(s)


@settings(max_examples=10, deadline=None)
@given(CLOS3, RAIL, MESH, st.integers(0, 2**30))
def test_walks_equal_reference(clos, rail, mesh, seed):
    """Every (src, dst) pair with a drawn (flow, EV) walks the same queues."""
    rng = np.random.default_rng(seed)
    for s in _strings(clos, rail, mesh):
        js, ts = _same_spec(s)
        for src in range(js.n_hosts):
            for dst in range(js.n_hosts):
                flow, ev = (int(v) for v in rng.integers(0, 1 << 16, size=2))
                assert ts.walk(src, dst, flow, ev) == js.walk(src, dst, flow, ev), (s, src, dst)


@pytest.mark.parametrize("fabric", TABLE_FABRICS)
def test_corners_and_named_fabrics_equal_reference(fabric):
    js, ts = _same_spec(fabric)
    ts.validate()
    assert ts.walk(0, ts.n_hosts - 1, 7, 11) == js.walk(0, js.n_hosts - 1, 7, 11)


BAD = ["torus:x=2", "rail:tors=two", "rail:tors=2", "mesh:tors=2,hosts=2,planes=1,extra=3",
       "rail:tors=0,hosts=2,rails=1", "clos3:pods=1,tors=1,hosts=1,aggs=0,up=1",
       "mesh:tors=2,hosts=2", "rail:tors=2,,hosts=1,rails=x", ":"]


@pytest.mark.parametrize("s", BAD)
def test_errors_equal_reference(s):
    with pytest.raises(ValueError) as je:
        jgen.build_spec(s)
    with pytest.raises(ValueError) as te:
        tgen.build_spec(s)
    assert str(te.value) == str(je.value)


def test_fabric_hosts_must_match_config():
    from repro_torch.netsim import SimConfig, Topology

    with pytest.raises(ValueError, match="must agree"):
        Topology.build(SimConfig(n_hosts=32, fabric=TABLE_FABRICS[1]))


def _jax_topology(fabric):
    spec = jgen.build_spec(fabric)
    return jtopo.Topology.build(JConfig(n_hosts=spec.n_hosts, hosts_per_tor=spec.n_hosts,
                                        fabric=fabric))


@pytest.mark.parametrize("fabric", TABLE_FABRICS)
def test_table_routing_equals_reference(fabric):
    """Reference form (garbage hosts and queues included) and engine form,
    ECMP and adaptive, with and without the penalty: the port's
    ``next_queue`` / ``route`` == the reference's ``TableTopology``."""
    jt, tt = _jax_topology(fabric), table_topology(fabric)
    assert (tt.n_queues, tt.t0_down_base, tt.diameter) == (jt.n_queues, jt.t0_down_base,
                                                         jt.diameter)
    assert np.array_equal(tt.t0_up_queues(0), jt.t0_up_queues(0))
    NQ = jt.n_queues
    for seed in range(3):
        c = table_route_case(tt.spec, 10 * seed + len(fabric), penalty=seed != 1)
        NP, NC = c["NP"], c["NC"]
        T = lambda k: torch.as_tensor(c[k])
        for adaptive in (False, True):
            # the reference form, on the per-arrival (garbage-laden) inputs
            q_eff = c["q_len"] + c["q_pen"]
            want = np.asarray(jt.next_queue(
                jnp.asarray(c["inj"]), jnp.asarray(c["cur"]), jnp.asarray(c["flow"]),
                jnp.asarray(c["ev"]), jnp.asarray(c["src"]), jnp.asarray(c["dst"]),
                jnp.asarray(q_eff), adaptive=adaptive))
            got = tt.next_queue(T("inj"), T("cur"), T("flow"), T("ev"), T("src"), T("dst"),
                                torch.as_tensor(q_eff), adaptive)
            assert np.array_equal(got.numpy(), want), (fabric, seed, adaptive, "reference form")
            # the engine form against the JAX engine's arrivals sequence
            pkt, a_idx = jnp.asarray(c["pkt"]), jnp.asarray(c["a_idx"])
            a_valid = a_idx < NP
            A = pkt[:, jnp.minimum(a_idx, NP - 1)]
            a_conn = jnp.where(a_valid, A[PCONN], 0)
            cc = jnp.clip(a_conn, 0, NC - 1)
            target = jt.next_queue(
                jnp.where(a_valid, A[PHOP], 1) == 0, jnp.where(a_valid, A[PCURQ], 0), a_conn,
                jnp.where(a_valid, A[PEV], 0), jnp.asarray(c["conn_src"])[cc],
                jnp.asarray(c["conn_dst"])[cc], jnp.asarray(q_eff), adaptive=adaptive)
            want = np.asarray(jnp.where(a_valid, target, NQ))
            Ap = T("pkt")[:, T("a_idx").clamp(max=NP - 1)]
            got = tt.route(T("a_idx"), NP, Ap[PHOP], Ap[PCURQ], Ap[PCONN], Ap[PEV], T("conn_src"),
                           T("conn_dst"), T("q_len"), T("q_pen"), adaptive)
            assert np.array_equal(got.numpy(), want), (fabric, seed, adaptive, "engine form")


def test_adaptive_ties_pick_the_first_least():
    """Adaptive routing over equal queue lengths takes the first candidate,
    and a lane past the switch's degree never wins."""
    tt = table_topology("rail:tors=4,hosts=4,rails=4")
    NQ = tt.n_queues
    inj = torch.ones(4, dtype=torch.bool)
    src = torch.tensor([0, 4, 8, 12], dtype=torch.int32)
    dst = torch.tensor([5, 9, 13, 1], dtype=torch.int32)
    z = torch.zeros(4, dtype=torch.int32)
    got = tt.next_queue(inj, z - 1, z, z, src, dst, torch.zeros(NQ, dtype=torch.int32), True)
    assert got.tolist() == [int(tt.t0_up_queues(t)[0]) for t in range(4)]
