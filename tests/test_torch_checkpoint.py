"""The port's checkpoints (repro_torch.checkpoint) on the CPU: the
hardening cases of tests/test_soak.py on the port's module (atomic commit
and extra round trip, ``latest`` skipping uncommitted and corrupt
snapshots, ``prune``, retry on ``OSError``, the async worker's exception,
the soak fingerprint), exact round trips of the simulator's state trees
and the path-keyed flatten of ``repro_torch.tree``."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.configs import FATTREE_32_CI
from repro_torch.core import SwitchLB, make_lb
from repro_torch.netsim import Simulator, workloads
from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like
from soak_parity import CHUNK, SLOTS, T, bits, engine, grid

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


def _tiny_trees(v=0):
    return {"state": {"x": np.arange(4, dtype=np.int32) + v}}


def test_save_commit_is_atomic_and_extra_roundtrips(tmp_path):
    base = str(tmp_path)
    p = os.path.join(base, "step_5")
    ckpt.save(p, 5, _tiny_trees(), extra={"soak": {"cursor": 5, "inj": []}})
    assert ckpt.is_committed(p)
    assert not [d for d in os.listdir(base) if ".tmp." in d]
    assert ckpt.read_manifest(p)["soak"] == {"cursor": 5, "inj": []}
    out, step = ckpt.restore(p, {"state": _tiny_trees()["state"]})
    assert step == 5
    np.testing.assert_array_equal(out["state"]["x"].numpy(), _tiny_trees()["state"]["x"])
    with pytest.raises(ValueError, match="collides"):
        ckpt.save(os.path.join(base, "step_6"), 6, _tiny_trees(), extra={"step": 1})


def test_latest_skips_uncommitted_and_corrupt(tmp_path):
    base = str(tmp_path)
    for i in (1, 2, 3):
        ckpt.save(os.path.join(base, f"step_{i}"), i, _tiny_trees(i))
    os.unlink(os.path.join(base, "step_2", "COMMITTED"))  # interrupted
    with open(os.path.join(base, "step_3", "manifest.json"), "w") as f:
        f.write("{ truncated")  # corrupt
    assert ckpt.latest(base) == os.path.join(base, "step_1")
    os.unlink(os.path.join(base, "step_1", "COMMITTED"))
    assert ckpt.latest(base) is None
    with pytest.raises(FileNotFoundError):
        ckpt.read_manifest(os.path.join(base, "step_2"))


def test_prune_keeps_last_k_and_sweeps_stale_dirs(tmp_path):
    base = str(tmp_path)
    for i in range(1, 6):
        ckpt.save(os.path.join(base, f"step_{i}"), i, _tiny_trees(i))
    os.makedirs(os.path.join(base, "step_9.tmp.123"))  # stale staging
    os.makedirs(os.path.join(base, "step_7"))  # uncommitted husk
    deleted = ckpt.prune(base, keep=2)
    assert sorted(os.listdir(base)) == ["step_4", "step_5"]
    assert len(deleted) == 5
    with pytest.raises(ValueError):
        ckpt.prune(base, keep=0)


def test_save_retries_transient_oserror(tmp_path, monkeypatch):
    real = ckpt_mod._save_once
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return real(*a, **kw)

    monkeypatch.setattr(ckpt_mod, "_save_once", flaky)
    p = os.path.join(str(tmp_path), "step_1")
    with pytest.raises(OSError):
        ckpt.save(p, 1, _tiny_trees(), retries=1, backoff_s=0.0)
    calls["n"] = 0
    ckpt.save(p, 1, _tiny_trees(), retries=2, backoff_s=0.0)
    assert calls["n"] == 3 and ckpt.is_committed(p)


def test_save_async_surfaces_worker_exception(tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("a file where the snapshot directory's parent should be")
    handle = ckpt.save_async(str(blocker / "ck" / "step_1"), 1, _tiny_trees())
    with pytest.raises(OSError):
        handle.join()
    ok = ckpt.save_async(str(tmp_path / "ok" / "step_1"), 1, _tiny_trees())
    ok.join()
    assert ckpt.is_committed(str(tmp_path / "ok" / "step_1"))


def test_save_async_snapshots_before_returning(tmp_path):
    """The host copy is taken when ``save_async`` returns: a later change
    of the tensor does not reach the snapshot."""
    x = torch.arange(6, dtype=torch.int32)
    h = ckpt.save_async(str(tmp_path / "step_1"), 1, {"t": {"x": x}})
    x += 100
    h.join()
    out, _ = ckpt.restore(str(tmp_path / "step_1"), {"t": {"x": x}})
    assert out["t"]["x"].tolist() == list(range(6))


def test_restore_with_axes_raises(tmp_path):
    p = str(tmp_path / "step_1")
    ckpt.save(p, 1, _tiny_trees())
    with pytest.raises(NotImplementedError, match="item 12"):
        ckpt.restore(p, _tiny_trees(), axes={"state": {"x": ("conns",)}})


@pytest.mark.parametrize("lbn", ["reps", "switch", "mixed"])
def test_state_trees_round_trip_exactly(tmp_path, lbn):
    """A simulator's state after 150 ticks (int32, bool, float32 leaves; a
    SwitchLB's nested tuples; a key) -> npz -> tensors: every leaf equal in
    value, dtype and shape, on the example's device."""
    import repro_torch.netsim.mixed  # noqa: F401

    cfg = FATTREE_32_CI
    lb = (SwitchLB([make_lb("ops", evs_size=cfg.evs_size), make_lb("reps", evs_size=cfg.evs_size)])
          if lbn == "switch" else make_lb(lbn, evs_size=cfg.evs_size, **(
              {"fg": "reps", "bg": "plb", "bg_conns": (1, 2)} if lbn == "mixed" else {})))
    sim = Simulator(cfg, workloads.permutation(32, 40, seed=2), lb, device="cpu")
    state, _ = sim.run(150)
    trees = {"carry": (state, torch.ones((2, 5), dtype=torch.int32)), "keys": sim.base_key}
    ckpt.save(str(tmp_path / "step_150"), 150, trees)
    out, step = ckpt.restore(str(tmp_path / "step_150"), trees)
    assert step == 150
    a, b = tree_flatten_with_path(trees), tree_flatten_with_path(out)
    assert a.keys() == b.keys() and "keys/_" not in a
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k
    rebuilt = tree_unflatten_like(trees, a)
    assert tree_flatten_with_path(rebuilt).keys() == a.keys()


def test_tree_paths_are_stable_names():
    tree = {"b0": ({"x": torch.zeros(1)}, [torch.ones(2)]), "k": torch.zeros(3)}
    assert list(tree_flatten_with_path(tree)) == ["b0/0/x", "b0/1/0", "k"]
    assert list(tree_flatten_with_path(torch.zeros(2))) == ["_"]


def test_resume_rejects_fingerprint_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    cfg = T.net.SoakConfig(chunk=CHUNK, ckpt_dir=d)
    T.net.SoakRunner(engine(T), cfg).advance(CHUNK)
    other = T.net.SweepEngine(T.cfg, grid(T)[:1], devices=None, min_failure_slots=SLOTS,
                              device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        T.net.SoakRunner(other, cfg).resume()
    with pytest.raises(FileNotFoundError):
        T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK,
                                                     ckpt_dir=str(tmp_path / "none"))).resume()


def test_async_save_soak_run_bit_exact(tmp_path):
    """``async_save`` through the real run path: a run abandoned after two
    chunks resumes from a committed snapshot and ends bit-equal to the
    batch sweep."""
    golden = bits(engine(T).run(collect="summary", chunk=CHUNK))
    cfg = T.net.SoakConfig(chunk=CHUNK, ckpt_dir=str(tmp_path / "ck"), async_save=True)
    first = T.net.SoakRunner(engine(T), cfg)
    first.advance(2 * CHUNK)
    first._join_pending()
    del first
    resumed = T.net.SoakRunner(engine(T), cfg).resume()
    assert resumed.cursor == 2 * CHUNK
    resumed.advance(360)
    from soak_parity import assert_bits_equal

    assert_bits_equal(bits(resumed.result()), golden, "async")


def test_soak_fig07_cli_record_equals_reference_and_survives_a_kill(tmp_path):
    """``python -m repro_torch.bench.soak_fig07`` (its own copy of the
    reference CLI's grid and record): the straight run's JSON record equals
    the reference CLI's byte for byte, and a run killed at a boundary
    (exit 137) and resumed writes the same record."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    # one thread per process: the suite's parallel workers share the host's cores
    env = dict(os.environ, PYTHONPATH=f"{repo / 'src'}{os.pathsep}{repo}", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    base = ["--ticks", "120", "--chunk", "60", "--trace", "256"]

    def cli(module, *args):
        return subprocess.run([sys.executable, "-m", module, *base, *args], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=300)

    port = "repro_torch.bench.soak_fig07"
    a, b, j = (str(tmp_path / f) for f in ("a.json", "b.json", "j.json"))
    assert cli(port, "--ckpt", str(tmp_path / "ca"), "--device", "cpu", "--out", a).returncode == 0
    assert cli("benchmarks.soak_fig07", "--ckpt", str(tmp_path / "cj"), "--out", j).returncode == 0
    killed = cli(port, "--ckpt", str(tmp_path / "cb"), "--device", "cpu", "--kill-at", "60")
    assert killed.returncode == 137, killed.stderr
    resumed = cli(port, "--ckpt", str(tmp_path / "cb"), "--device", "cpu", "--resume", "--out", b)
    assert resumed.returncode == 0 and "resumed at cursor 60" in resumed.stdout
    text = open(a).read()
    assert text == open(j).read() == open(b).read()
    assert json.loads(text)["cursor"] == 240
