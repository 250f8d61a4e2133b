"""The sweep's row mesh (``SweepEngine(devices=N)`` over the ranks of a
``torch.distributed`` group; reference ``sweep.py:924-960, 1259-1281``) and
the sweep half of ``distrib.sharding`` (reference ``sharding.py:124-202``).

Two gloo ranks on this host (started once for the file by
``repro_torch.distrib.ranks.run_ranks``; the work is in
``tests/ranks_parity.py``) run the reference scale-mode test's grid without
scale mode: two buckets, one with a row frozen at its shorter horizon, each
padded to the two ranks.  Every row's ``SimState`` and trace equal the JAX
reference's ``serial_sim(...).run`` bit for bit on every rank (but the
load balancer's state, a ``SwitchLB``'s in the sweep, as the reference's
test excludes it); with the
early exit each bucket's ``ticks_run`` and every row's state and telemetry
carry equal the one-rank port's."""
from types import SimpleNamespace

import jax
import pytest
import torch

import repro.netsim as jnet
from repro.netsim import failures as jfailures, workloads as jworkloads
from repro.netsim.config import SimConfig as JConfig
from repro_torch.distrib import sharding as shd
from repro_torch.netsim import SweepEngine
from ranks_parity import (cfg, cases, port_cases, results, run_ranks_beside, sweep_mesh_work,
                          without_lb)
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

WORLD = 2


@pytest.fixture(scope="module")
def run():
    """The ranks' results, the JAX references (computed here while the
    ranks run) and the one-rank port's early-exit run."""

    def refs():
        jcfg = JConfig(**{k: getattr(cfg(False), k) for k in ("n_hosts", "hosts_per_tor",
                                                               "uplinks_per_tor", "rto_ticks")})
        jeng = jnet.SweepEngine(jcfg, cases(jnet, jworkloads, jfailures))
        out = {}
        for c in jeng.cases:
            for si, seed in enumerate(c.seeds):
                st, tr = jax.block_until_ready(jeng.serial_sim(c.name, seed=seed).run(c.ticks))
                out[(c.name, si)] = (without_lb(jax_state_to_numpy(st)), tr)
        one = SweepEngine(cfg(False), port_cases(), devices=1, device="cpu")
        return out, results(one, one.run(collect="summary", early_exit=True), "summary")

    ranks, (serial, single) = run_ranks_beside(sweep_mesh_work, WORLD, refs)
    return SimpleNamespace(ranks=ranks, refs=serial, single=single)


def test_mesh_helpers_without_a_group():
    assert shd.sweep_mesh() is None and shd.sweep_mesh(4) is None
    assert shd.pad_rows(3, None) == 3
    with pytest.raises(ValueError, match="conn_devices=2 exceeds the 1 visible devices"):
        shd.sweep_conn_mesh(2)
    stand_in = SimpleNamespace(axis_names=("rows",), shape={"rows": 4})
    assert [shd.pad_rows(n, stand_in) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert shd.mesh_platform(None) == ("gpu" if torch.cuda.is_available() else "cpu")


def test_mesh_helpers_over_the_ranks(run):
    for m in (r["meshes"] for r in run.ranks):
        assert m["all"] == (WORLD,) and m["names"] == ("rows",) and m["one"] is None
        assert m["conn"] == (1, 2) and m["conn_names"] == ("rows", "conns")
        assert m["pad"] == [2, 2, 4, 6]
        assert m["platform"] == "cpu"
        assert f"conn_devices={WORLD + 1} exceeds the {WORLD} visible devices" in m["too_many"]


def test_each_rank_steps_its_block_of_padded_rows(run):
    assert [r["row_rank"] for r in run.ranks] == list(range(WORLD))
    for r in run.ranks:
        assert r["n_devices"] == WORLD
        assert r["padded"] == [4, 2]  # 3 + 1 pad row, 1 + 1 pad row
        assert r["local_rows"] == [p // WORLD for p in r["padded"]]
        assert r["full"]["plan"] == run.ranks[0]["full"]["plan"]
        assert "2 devices" in r["full"]["plan"]
        assert "devices=None or 1" in r["soak"]  # the soak runtime takes one rank's engine


def test_rows_equal_the_jax_serial_runs(run):
    for rank, r in enumerate(run.ranks):
        rows = r["full"]["rows"]
        assert rows.keys() == run.refs.keys()
        for key, (jst, jtr) in run.refs.items():
            where = f"rank {rank} {key}"
            assert_states_equal(jst, without_lb(rows[key]["state"]), where)
            for f in jtr._fields:
                want = jax.device_get(getattr(jtr, f))
                got = rows[key]["trace"][f]
                assert got.shape == want.shape and got.dtype == want.dtype, (where, f)
                assert (got == want).all(), (where, f)


def test_early_exit_agrees_with_one_rank(run):
    single = run.single
    assert any(t < ticks for t, ticks in zip(single["ticks_run"], (400, 250)))  # it fires
    for rank, r in enumerate(run.ranks):
        s = r["summary"]
        assert s["ticks_run"] == single["ticks_run"], rank
        for key, want in single["rows"].items():
            assert_states_equal(want["state"], s["rows"][key]["state"], f"rank {rank} {key}")
            assert (s["rows"][key]["telemetry"] == want["telemetry"]).all(), (rank, key)
