"""The port's traced soak (``SoakConfig(trace=TraceSpec(...))``) on the
CPU: tracing is invisible on every summary, carry and state; the flight
parts equal JAX's array by array and ``tools/trace_export.py`` makes the
same JSON from the port's ``flight/`` directory as from JAX's; killed and
resumed, the rings and parts equal the straight run's; ``inspect`` shows
the ring; the fingerprint keeps trace-on and trace-off snapshots apart.
The grid is tests/test_soak.py's (tests/soak_parity.py)."""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

import repro.netsim.tracer as jtracer
import repro_torch.netsim.tracer as ttracer
from soak_parity import CHUNK, TICKS, J, T, assert_bits_equal, bits, engine

RING = 512
REPO = Path(__file__).resolve().parents[1]


def _trace_spec(m):
    return (ttracer if m is T else jtracer).TraceSpec(ring=RING)


def _flight(res):
    return {(n, i): res.flight_for(n, i) for n, seeds in (("a", 2), ("b", 1), ("c", 1))
            for i in range(seeds)}


def _parts(d):
    fd = os.path.join(d, "flight")
    out = {}
    for f in sorted(os.listdir(fd)):
        if f.endswith(".npz"):
            with np.load(os.path.join(fd, f)) as z:
                out[f] = {k: z[k] for k in z.files}
    return out


def _assert_parts_equal(got, want):
    assert sorted(got) == sorted(want)
    for f in want:
        assert sorted(got[f]) == sorted(want[f]), f
        for k in want[f]:
            a, b = got[f][k], want[f][k]
            assert a.shape == b.shape, (f, k, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"{f}:{k}")


def _run(m, d, kill_at=None):
    cfg = m.net.SoakConfig(chunk=CHUNK, ckpt_dir=d, trace=_trace_spec(m))
    soak = m.net.SoakRunner(engine(m), cfg)
    if kill_at is not None:
        soak.advance(kill_at)
        del soak
        soak = m.net.SoakRunner(engine(m), cfg).resume()
        assert soak.cursor == kill_at
    soak.advance(TICKS)
    return soak.result()


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    base = tmp_path_factory.mktemp("traced")
    jd, td = str(base / "jax"), str(base / "port")
    jres, tres = _run(J, jd), _run(T, td)
    return {"jax": (jd, jres), "port": (td, tres)}


def test_traced_soak_matches_reference_and_is_invisible(goldens):
    jd, jres = goldens["jax"]
    td, tres = goldens["port"]
    got = bits(tres)
    assert_bits_equal(got, bits(jres, J), "traced, port vs JAX")
    assert_bits_equal(got, bits(engine(T).run(collect="summary", chunk=CHUNK)), "on vs off")
    tf, jf = _flight(tres), _flight(jres)
    for key in jf:
        for k in ("seq", "tick", "code", "value"):
            np.testing.assert_array_equal(np.asarray(tf[key][k]), np.asarray(jf[key][k]))
        for k in ("cursor", "lost", "first_drop_tick", "first_redeliver_tick"):
            assert tf[key][k] == jf[key][k], (key, k)
    assert any(ev["cursor"] > 0 for ev in tf.values())
    _assert_parts_equal(_parts(td), _parts(jd))
    with open(os.path.join(td, "flight", "flight_meta.json")) as f:
        tmeta = json.load(f)
    with open(os.path.join(jd, "flight", "flight_meta.json")) as f:
        assert tmeta == json.load(f)


def test_trace_export_reads_the_port_flight_dir_as_the_reference(goldens):
    spec = importlib.util.spec_from_file_location("trace_export", REPO / "tools" / "trace_export.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jd, _ = goldens["jax"]
    td, _ = goldens["port"]
    got = mod.export(os.path.join(td, "flight"))
    want = mod.export(os.path.join(jd, "flight"))
    # the export names its input directory; everything else must agree
    assert (json.dumps(got, sort_keys=True).replace(td, "<ckpt>")
            == json.dumps(want, sort_keys=True).replace(jd, "<ckpt>"))
    assert got["traceEvents"]


@pytest.mark.parametrize("kill_at", [CHUNK, 2 * CHUNK])
def test_traced_kill_resume_rings_and_parts_bit_exact(tmp_path, goldens, kill_at):
    td, tres = goldens["port"]
    d = str(tmp_path / "ck")
    res = _run(T, d, kill_at=kill_at)
    assert_bits_equal(bits(res), bits(tres), f"traced kill at {kill_at}")
    got, want = _flight(res), _flight(tres)
    for key in want:
        for k in ("seq", "tick", "code", "value"):
            np.testing.assert_array_equal(got[key][k], want[key][k], err_msg=str(key))
        for k in ("cursor", "lost", "first_drop_tick", "first_redeliver_tick"):
            assert got[key][k] == want[key][k], (key, k)
    _assert_parts_equal(_parts(d), _parts(td))


def test_traced_inspect_exposes_flight_tail_mid_run(tmp_path):
    soak = T.net.SoakRunner(engine(T), T.net.SoakConfig(
        chunk=CHUNK, ckpt_dir=str(tmp_path / "ck"), trace=_trace_spec(T)))
    soak.advance(CHUNK)
    info = soak.inspect()
    assert all("flight" in v for v in info.values())
    fl = info["a"]["flight"]
    assert fl["cursor"] > 0 and np.all(np.asarray(fl["tick"]) < CHUNK)


def test_trace_on_fingerprint_rejects_trace_off_snapshot(tmp_path):
    d = str(tmp_path / "ck")
    T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK, ckpt_dir=d)).advance(CHUNK)
    cfg_on = T.net.SoakConfig(chunk=CHUNK, ckpt_dir=d, trace=_trace_spec(T))
    with pytest.raises(ValueError, match="fingerprint"):
        T.net.SoakRunner(engine(T), cfg_on).resume()


def test_trace_requires_summary_collect():
    with pytest.raises(ValueError, match="summary"):
        T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK, collect="full",
                                                      trace=_trace_spec(T)))
