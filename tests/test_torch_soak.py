"""The port's soak runtime (repro_torch.netsim.soak) on the CPU: run
straight through it equals JAX's SoakRunner on the same grid (summaries,
telemetry carries, final states) and the port's batch sweep; killed at a
chunk boundary and resumed by a fresh engine and runner, in summary and
in full mode, it equals its straight run bit for bit; ``inspect`` reads
the live cursor.  The grid is tests/test_soak.py's (tests/soak_parity.py).
Injection is held in tests/test_torch_soak_inject.py, the traced soak in
tests/test_torch_soak_trace.py."""
import numpy as np
import pytest

from soak_parity import CHUNK, TICKS, J, T, assert_bits_equal, bits, engine


@pytest.fixture(scope="module")
def golden():
    """The port's batch sweep of the grid in summary mode."""
    return bits(engine(T).run(collect="summary", chunk=CHUNK))


def test_grid_has_frozen_row_and_two_buckets():
    eng = engine(T)
    assert len(eng.buckets) >= 2, eng.plan.describe()
    assert any(b.program.masked for b in eng.buckets)


def test_soak_straight_through_equals_reference_and_batch(tmp_path, golden):
    jsoak = J.net.SoakRunner(engine(J), J.net.SoakConfig(chunk=CHUNK))
    jsoak.advance(TICKS)
    want = bits(jsoak.result(), J)
    soak = T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK,
                                                        ckpt_dir=str(tmp_path / "ck")))
    soak.advance(TICKS)
    assert soak.done and soak.cursor == TICKS
    got = bits(soak.result())
    assert_bits_equal(got, want, "port soak vs JAX soak")
    assert_bits_equal(got, golden, "soak vs batch")
    with pytest.raises(RuntimeError, match="finalized"):
        soak.advance(1)


@pytest.mark.parametrize("kill_at", [CHUNK, 2 * CHUNK])
def test_kill_at_chunk_boundary_resumes_bit_exact(tmp_path, golden, kill_at):
    cfg = T.net.SoakConfig(chunk=CHUNK, ckpt_dir=str(tmp_path / "ck"))
    first = T.net.SoakRunner(engine(T), cfg)
    first.advance(kill_at)
    assert first.cursor == kill_at
    keys = [b.keys.clone() for b in first.engine.buckets]
    del first  # the preemption: nothing survives but the snapshots
    fresh = engine(T)
    for b in fresh.buckets:  # the keys come from the snapshot, not the engine
        b.keys = b.keys.flip(0).contiguous()
    resumed = T.net.SoakRunner(fresh, cfg)
    resumed.fingerprint = T.net.SoakRunner(engine(T), cfg).fingerprint
    resumed.resume()
    assert resumed.cursor == kill_at
    for b, k in zip(resumed.engine.buckets, keys):
        assert np.array_equal(b.keys.numpy(), k.numpy())
    resumed.advance(TICKS)
    assert_bits_equal(bits(resumed.result()), golden, f"kill at {kill_at}")


def test_kill_resume_full_traces_bit_exact(tmp_path):
    golden = engine(T).run(collect="full", chunk=CHUNK)
    cfg = T.net.SoakConfig(chunk=CHUNK, ckpt_dir=str(tmp_path / "ck"), collect="full")
    first = T.net.SoakRunner(engine(T), cfg)
    first.advance(CHUNK)
    del first
    resumed = T.net.SoakRunner(engine(T), cfg).resume()
    assert resumed.cursor == CHUNK and len(resumed.trace_parts[0]) == 1
    resumed.advance(TICKS)
    res = resumed.result()
    for name in ("a", "b", "c"):
        tg, tr = golden.trace_for(name), res.trace_for(name)
        for f in tg._fields:
            np.testing.assert_array_equal(getattr(tr, f).numpy(), getattr(tg, f).numpy())
    assert_bits_equal(bits(res), bits(golden), "full")


def test_inspect_reports_live_cursor_and_telemetry():
    soak = T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK))
    soak.advance(CHUNK)
    info = soak.inspect()
    assert set(info) == {"a", "b", "c"}
    assert info["a"]["cursor"] == CHUNK and not info["a"]["done"]
    assert info["b"]["ticks"] == 300
    assert info["a"]["telemetry"]["counters"]["injected"] > 0
    with pytest.raises(RuntimeError, match="not finished"):
        soak.result()
    soak.advance(TICKS)
    assert soak.inspect()["b"]["done"] and soak.inspect()["b"]["cursor"] == 300
