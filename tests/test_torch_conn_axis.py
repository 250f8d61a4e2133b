"""Scale mode's connection axis over several ranks
(``SweepEngine(conn_devices=2)``, ``Simulator.step_rows(conn_axis=)``;
reference ``engine.py:858-903, 966-985, 1541-1552``, ``sweep.py:924-934,
989-992, 1196-1203, 1283-1306``).

Four gloo ranks on this host (started once for the file by
``repro_torch.distrib.ranks.run_ranks``; the work is in
``tests/ranks_parity.py``) form a (rows 2, conns 2) mesh and run the exact
cases of ``tests/test_scale_mode.py:41-63`` (16 hosts, the two-failure
schedule, a/reps, b/ecmp, c/adaptive_roce): on every rank every row's
leaves but the load balancer's state (as the reference's test excludes
it) and every trace equal the JAX reference's ``serial_sim(...).run``
bit for bit.  Both guard rails raise ``ValueError``, and each rank's
bitmaps hold its ``NC / 2`` connections plus its own drop row."""
from types import SimpleNamespace

import jax
import pytest
import torch

import repro.netsim as jnet
from repro.netsim import failures as jfailures, workloads as jworkloads
from repro.netsim.config import SimConfig as JConfig
from repro_torch.netsim.engine import ConnShard, shard_conn_state
from ranks_parity import cfg, cases, conn_axis_work, run_ranks_beside, without_lb
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

WORLD = 4


@pytest.fixture(scope="module")
def run():
    """The ranks' results and the JAX references (computed here while the
    ranks run)."""

    def refs():
        c = cfg(True)
        jcfg = JConfig(**{k: getattr(c, k) for k in ("n_hosts", "hosts_per_tor",
                                                      "uplinks_per_tor", "rto_ticks",
                                                      "conn_sharding")})
        jeng = jnet.SweepEngine(jcfg, cases(jnet, jworkloads, jfailures))
        out = {}
        for case in jeng.cases:
            for si, seed in enumerate(case.seeds):
                sim = jeng.serial_sim(case.name, seed=seed)
                st, tr = jax.block_until_ready(sim.run(case.ticks))
                out[(case.name, si)] = (without_lb(jax_state_to_numpy(st)), tr)
        return out

    ranks, serial = run_ranks_beside(conn_axis_work, WORLD, refs)
    return SimpleNamespace(ranks=ranks, refs=serial)


def test_mesh_places_the_ranks(run):
    assert [r["mesh"] for r in run.ranks] == [(2, 2)] * WORLD
    assert [r["coord"] for r in run.ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    plans = {r["full"]["plan"] for r in run.ranks}
    assert len(plans) == 1 and "2 buckets" in plans.pop()


def test_rows_equal_the_jax_serial_runs(run):
    for rank, r in enumerate(run.ranks):
        rows = r["full"]["rows"]
        assert rows.keys() == run.refs.keys() and len(rows) == 4
        for key, (jst, jtr) in run.refs.items():
            where = f"rank {rank} {key}"
            assert_states_equal(jst, without_lb(rows[key]["state"]), where)
            for f in jtr._fields:
                want = jax.device_get(getattr(jtr, f))
                got = rows[key]["trace"][f]
                assert got.shape == want.shape and got.dtype == want.dtype, (where, f)
                assert (got == want).all(), (where, f)


def test_step_scenario_on_the_axis_equals_the_whole_run(run):
    """``step_scenario(conn_axis=)`` for 200 ticks (past the RTO, through
    both failure windows), gathered, equals the unsharded run on every
    leaf, the load balancer's included; also with a 12-tick RTO and
    trimming, where retransmissions are delivered twice and NACKs read
    both bitmaps."""
    for rank, r in enumerate(run.ranks):
        for i, (whole, back) in enumerate(r["step_scenario"]):
            assert_states_equal(whole, back, f"rank {rank} case {i}")
            assert int(whole["s_stats"][2]) > 0  # timeouts fired
        whole = r["step_scenario"][1][0]
        assert int(whole["s_stats"][5]) > int(whole["s_stats"][3])  # injected > delivered


def test_guard_rails_raise(run):
    for r in run.ranks:
        assert "conn_sharding" in r["errors"]["opt_in"]
        assert "conn_devices" in r["errors"]["summary"]


def test_each_rank_holds_half_the_connections_and_a_drop_row(run):
    for r in run.ranks:
        assert [b[1] for b in r["bitmaps"]] == [4, 2]  # 3 + 1 pad rows, 1 + 1
        for nc, padded, rtx, rcv, inflight in r["bitmaps"]:
            rows = padded // 2  # this rank's share of the rows
            assert inflight == (rows, nc // 2)
            assert rtx[:2] == rcv[:2] == (rows, nc // 2 + 1)


def test_shard_conn_state_cuts_each_block():
    """Without a group: the cut ``shard_conn_state`` makes for rank 1 of 2
    (no collective runs)."""
    from repro_torch.core import make_lb
    from repro_torch.netsim import Simulator
    from repro_torch.netsim.engine import add_rows
    from ranks_parity import port_cases

    case = port_cases()[0]
    sim = Simulator(cfg(True), case.workload, make_lb("reps"), device="cpu")
    st = add_rows(sim.init_state())
    st.c_rtx[0, 9, 1] = True
    cut = shard_conn_state(st, ConnShard(group=None, rank=1, size=2))
    assert cut.c_inflight.shape == (1, 8) and cut.c_rtx.shape == (1, 9, sim.MSG)
    assert bool(cut.c_rtx[0, 1, 1]) and int(cut.c_rtx.sum()) == 1  # conn 9 is row 1 of rank 1
    assert torch.equal(cut.c_cwnd, st.c_cwnd[:, 8:]) and cut.pkt is st.pkt
    with pytest.raises(ValueError, match="do not split"):
        ConnShard(group=None, rank=0, size=3).block(16)
