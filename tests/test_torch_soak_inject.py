"""Failure injection through the port's soak runtime on the CPU: a spine
failure injected at a chunk boundary equals the same failure declared in
every case up front, bit for bit (and JAX's injected run); the injection
survives a kill and resume; bad deltas and a grid without headroom raise
before any state changes.  The grid is tests/test_soak.py's
(tests/soak_parity.py)."""
import pytest

from soak_parity import CHUNK, TICKS, J, T, assert_bits_equal, bits, engine


def _static(spine):
    delta = T.net.failures.spine_down(T.cfg, spine, start=CHUNK)
    return bits(engine(T, extra_failures=delta).run(collect="summary", chunk=CHUNK))


def test_injection_equals_static_schedule_and_reference(tmp_path):
    static = _static(0)
    soak = T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK,
                                                        ckpt_dir=str(tmp_path / "ck")))
    soak.advance(CHUNK)
    soak.inject(T.net.failures.spine_down(T.cfg, 0, start=CHUNK))
    assert soak.injections[0]["at_tick"] == CHUNK
    soak.advance(TICKS)
    got = bits(soak.result())
    assert_bits_equal(got, static, "injected vs static")
    jsoak = J.net.SoakRunner(engine(J), J.net.SoakConfig(chunk=CHUNK))
    jsoak.advance(CHUNK)
    jsoak.inject(J.net.failures.spine_down(J.cfg, 0, start=CHUNK))
    jsoak.advance(TICKS)
    assert_bits_equal(got, bits(jsoak.result(), J), "port vs JAX, injected")


def test_injection_survives_kill_and_resume(tmp_path):
    static = _static(1)
    cfg = T.net.SoakConfig(chunk=CHUNK, ckpt_dir=str(tmp_path / "ck"))
    first = T.net.SoakRunner(engine(T), cfg)
    first.advance(CHUNK)
    first.inject(T.net.failures.spine_down(T.cfg, 1, start=CHUNK))
    first.advance(CHUNK)  # one more boundary past the injection
    del first
    resumed = T.net.SoakRunner(engine(T), cfg).resume()
    assert resumed.cursor == 2 * CHUNK and len(resumed.injections) == 1
    resumed.advance(TICKS)
    assert_bits_equal(bits(resumed.result()), static, "injected, resumed")


def test_inject_rejects_bad_deltas():
    f = T.net.failures
    soak = T.net.SoakRunner(engine(T), T.net.SoakConfig(chunk=CHUNK))
    soak.advance(CHUNK)
    with pytest.raises(ValueError, match="past"):
        soak.inject(f.link_down([0], start=CHUNK - 10, end=f.FOREVER))
    soak.inject(f.spine_down(T.cfg, 0, start=CHUNK))
    with pytest.raises(ValueError, match="resurrect"):
        soak.inject(f.spine_down(T.cfg, 0, start=CHUNK + 5))
    # validation happens before any change: the run still equals the
    # single-injection static grid
    soak.advance(TICKS)
    assert_bits_equal(bits(soak.result()), _static(0), "after rejected deltas")


def test_inject_without_headroom_raises():
    eng = T.net.SweepEngine(T.cfg, [engine(T).cases[0]], devices=None, device="cpu")
    soak = T.net.SoakRunner(eng, T.net.SoakConfig(chunk=CHUNK))
    soak.advance(CHUNK)
    with pytest.raises(ValueError, match="min_failure_slots"):
        soak.inject(T.net.failures.spine_down(T.cfg, 0, start=CHUNK))
