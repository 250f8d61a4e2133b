"""The port's user examples (``python -m repro_torch.examples.<name>``) on
the CPU at cut horizons: quickstart's five runs, printed and returned,
against the reference's ``Simulator.run`` + ``summarize`` on the same
inputs; failover_demo's injected spine against the same spine declared up
front through the port's ``SweepEngine`` and ``SoakRunner``; serve_batched
and train_lm cut to a few steps (finite outputs, the resume bit-equal);
paper_figures' three figures; the command lines; no device: a raise where
there is no GPU."""
import os
import shutil
import types

import numpy as np
import pytest
import torch

from test_torch_telemetry import assert_same, summary_dict
from repro_torch.examples import (
    failover_demo, paper_figures, quickstart, serve_batched, train_lm,
)
from repro_torch.tree import tree_flatten_with_path

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

HEALTHY, FAILURE = 140, 320  # OPS and REPS complete by tick 134; the uplinks fail at 300


def reference_failure_runs():
    """The reference script's failure block at the cut horizon, with its
    printed lines."""
    from repro.configs.arcane_paper import FATTREE_32_CI as cfg
    from repro.core import make_lb
    from repro.netsim import Simulator, Topology, failures, summarize, workloads

    wl = workloads.permutation(cfg.n_hosts, 64, seed=1)
    fs = failures.link_down(list(Topology.build(cfg).t0_up_queues(0)[:2]), 300, 2**30)
    runs, lines = {}, ["== two uplinks fail at t=300 =="]
    for lbn in ["ops", "reps"]:
        lb = make_lb(lbn, evs_size=cfg.evs_size,
                     **({"freezing_timeout": 600} if lbn == "reps" else {}))
        sim = Simulator(cfg, wl, lb, failures=fs, seed=0)
        s = runs["failure", lbn] = summarize(sim, sim.run(FAILURE)[0])
        lines.append(f"  {lbn:5s} runtime={s.runtime_ticks:5d} ticks  lost={s.drops_fail:3d} "
                     f"timeouts={s.timeouts}  (freezing mode reroutes within ~1 RTO)")
    return runs, lines


def test_quickstart_failure_runs_equal_reference(capsys):
    got = quickstart.main("cpu", healthy_ticks=HEALTHY, failure_ticks=FAILURE)
    printed = capsys.readouterr().out.splitlines()
    want, lines = reference_failure_runs()
    assert printed[0] == "== healthy symmetric network (64-pkt permutation) =="
    assert [ln.split()[0] for ln in printed[1:4]] == ["ecmp", "ops", "reps"]
    assert printed[4:] == lines
    assert sorted(got) == [("failure", "ops"), ("failure", "reps"), ("healthy", "ecmp"),
                           ("healthy", "ops"), ("healthy", "reps")]
    for k in want:
        assert summary_dict(got[k]) == summary_dict(want[k]), k
    for lbn in ("ops", "reps"):  # the 64-packet messages drain before the uplinks fail
        s = got["failure", lbn]
        assert s.completed == s.n_conns == 32 and s.runtime_ticks < 300 and s.drops_fail == 0


def run_static(ticks, spine, window):
    """The demo's grid with the spine declared up front, driven through the
    same advances."""
    from repro_torch.configs import FATTREE_32_CI as cfg
    from repro_torch.netsim import SoakConfig, SoakRunner, SweepEngine, failures

    fs = failures.spine_down(cfg, spine, start=250)
    engine = SweepEngine(cfg, failover_demo.cases(ticks, cfg, failure=fs), min_failure_slots=8,
                         device="cpu")
    soak = SoakRunner(engine, SoakConfig(chunk=250, collect="summary"))
    soak.advance(250)
    before = soak.inspect()
    soak.advance(window)
    live = soak.inspect()
    soak.advance(ticks)
    return before, live, soak.result()


def test_failover_demo_equals_failure_declared_up_front(capsys):
    ticks, window = 400, 100  # past the first re-routed delivery of both rows
    got = failover_demo.main("cpu", ticks=ticks, window=window)
    printed = capsys.readouterr().out
    assert got["at"] == 250 and "t=250: spine 2 down — 4 uplinks blackholed" in printed
    assert "t=350: live RecoveryTracker" in printed and "t=400: horizon reached" in printed
    before, live, res = run_static(ticks, 2, window)
    for name in ("ops", "reps"):
        assert_same(got["before"][name]["telemetry"], before[name]["telemetry"], name)
        assert_same(got["live"][name]["telemetry"], live[name]["telemetry"], name)
        r = live[name]["telemetry"]["recovery"]
        assert r["first_drop_tick"] >= 250 and r["first_redeliver_tick"] > r["first_drop_tick"]
        assert f"recovery={r['recovery_us']:.2f}us" in printed
        assert (summary_dict(got["result"].summaries()[name][0])
                == summary_dict(res.summaries()[name][0])), name
        assert_same(got["result"].telemetry_for(name), res.telemetry_for(name), name)
    s = res.summaries()
    assert f"reps: completed={s['reps'][0].completed:3d}/32" in printed


def test_serve_and_train_examples(tmp_path):
    from repro_torch.train import make_serve_steps

    out = serve_batched.main("cpu", gen=4)
    assert out["tokens"].shape == (4, 4) and out["prompts"].shape == (4, 32)
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < out["cfg"].vocab
    logits = make_serve_steps(out["model"])[0](out["params"], {"tokens": out["prompts"]}, 36)[0]
    assert bool(torch.isfinite(logits.float()).all())

    # resumed from a copy of the whole run's middle checkpoint (a run of
    # fewer steps would decay its rate sooner)
    kw = dict(device="cpu", steps=4, batch=2, seq=32, ckpt_every=2)
    whole = train_lm.main(ckpt_dir=str(tmp_path / "a"), **kw)
    shutil.copytree(tmp_path / "a" / "step_2", tmp_path / "b" / "step_2")
    resumed = train_lm.main(ckpt_dir=str(tmp_path / "b"), extra=["--resume"], **kw)
    assert np.isfinite(whole["losses"]).all() and np.isfinite(whole["grad_norms"]).all()
    assert resumed["start"] == 2 and resumed["losses"] == whole["losses"][2:]
    for name in ("params", "opt"):
        a, b = tree_flatten_with_path(whole[name]), tree_flatten_with_path(resumed[name])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
    assert train_lm.default_ckpt_dir().endswith("repro_torch_ckpt")
    assert train_lm.default_ckpt_dir() != "/tmp/repro_ckpt"


def test_paper_figures_runs_figures_1_3_6(monkeypatch, capsys):
    calls = []
    for mod in ("fig01_tornado_micro", "fig03_asym_micro", "fig06_failures_micro"):
        monkeypatch.setattr(f"repro_torch.bench.{mod}.main",
                            lambda rows, device, m=mod: calls.append((m, rows, device)))
    rows = paper_figures.main("cpu")
    assert capsys.readouterr().out == "name,us_per_call,derived\n"
    assert [c[0] for c in calls] == ["fig01_tornado_micro", "fig03_asym_micro",
                                     "fig06_failures_micro"]
    assert all(r is rows and d == torch.device("cpu") for _, r, d in calls)
    assert rows.context["device"] == "cpu"


def test_command_lines(monkeypatch):
    seen = {}
    monkeypatch.setattr("repro_torch.launch.train.main", lambda argv: seen.setdefault("t", argv))
    monkeypatch.setattr("repro_torch.launch.serve.main", lambda argv: seen.setdefault("s", argv))
    train_lm.cli(["--device", "cpu", "--steps", "300", "--resume"])
    argv = seen["t"]
    assert argv[-3:] == ["--steps", "300", "--resume"] and "--reduced" in argv
    assert argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("--ckpt-dir") + 1] == train_lm.default_ckpt_dir()
    serve_batched.cli(["--device", "cpu"])
    assert seen["s"] == ["--arch", "gemma3-4b", "--batch", "4", "--prompt-len", "32", "--gen",
                         "16", "--reduced", "--device", "cpu"]
    with pytest.raises(SystemExit):  # only --device
        quickstart.cli(["--steps", "3"])


@pytest.mark.parametrize("example", [quickstart, failover_demo, paper_figures, serve_batched,
                                     train_lm])
def test_device_omitted_raises_without_gpu(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main()


def test_time_all_runs_each_command_once(tmp_path, monkeypatch, capsys):
    from repro_torch.examples import time_all

    ran = []

    def fake_run(argv, stdout=None, stderr=None, env=None):
        ran.append((argv, env["PYTHONPATH"]))
        return types.SimpleNamespace(returncode=int("serve_batched" in " ".join(argv)))

    monkeypatch.setattr(time_all.subprocess, "run", fake_run)
    out = time_all.main("cpu", logs=str(tmp_path))
    assert list(out) == [*time_all.EXAMPLES, "bench_fig06_trace0", "bench_fig06_trace64"]
    assert [rc for rc, _ in out.values()] == [0, 0, 0, 1, 0, 0, 0]
    assert all(argv[-2:] == ["--device", "cpu"] for argv, _ in ran)
    assert ran[0][0][1:3] == ["-m", "repro_torch.examples.quickstart"]
    assert ran[6][0][1:7] == ["-m", "repro_torch.bench.run", "--only", "fig06", "--trace", "64"]
    assert ran[0][1].split(os.pathsep)[0].endswith("src")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(f"{n}.log" for n in out)
    assert "serve_batched: exit 1" in capsys.readouterr().out
