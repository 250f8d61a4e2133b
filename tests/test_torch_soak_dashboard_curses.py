"""The soak dashboard's curses view (``run_curses``, the reference's
``benchmarks/soak_dashboard.py:119-141``) over a stub screen: every chunk
draws the lines of ``frame(soak)`` clipped to the screen with the ``q``
prompt below them, ``q`` stops the run between chunks with the
checkpoints written so far kept, and the plain view is unchanged."""
import curses

import pytest

from repro_torch.bench import soak_dashboard as dash
from repro_torch.bench.common import ci_cfg
from repro_torch.bench.soak_fig07 import MIN_FAILURE_SLOTS, cases
from repro_torch.checkpoint import latest
from repro_torch.netsim import SoakConfig, SoakRunner, SweepEngine
from repro_torch.netsim.tracer import TraceSpec

TICKS, CHUNK = 40, 20


class StubScreen:
    """What ``run_curses`` calls on a curses window, recorded; ``keys`` are
    returned by ``getch`` in turn (-1, no key, once they run out)."""

    def __init__(self, h=12, w=60, keys=()):
        self.h, self.w, self.keys = h, w, list(keys)
        self.frames, self._lines, self.nodelay_set = [], {}, None

    def nodelay(self, flag):
        self.nodelay_set = flag

    def erase(self):
        self._lines = {}

    def getmaxyx(self):
        return self.h, self.w

    def addnstr(self, y, x, text, n):
        assert x == 0 and 0 <= y < self.h
        self._lines[y] = text[:n]

    def refresh(self):
        self.frames.append([self._lines[y] for y in sorted(self._lines)])

    def getch(self):
        return self.keys.pop(0) if self.keys else -1


def _soak(tmp_path, name):
    cfg = ci_cfg()
    eng = SweepEngine(cfg, cases(cfg, TICKS), min_failure_slots=MIN_FAILURE_SLOTS,
                      device="cpu")
    return cfg, SoakRunner(eng, SoakConfig(chunk=CHUNK, ckpt_dir=str(tmp_path / name),
                                           trace=TraceSpec(ring=64)))


@pytest.fixture
def stub_curses(monkeypatch):
    screens = []

    def wrapper(fn):
        fn(screens[-1])

    monkeypatch.setattr(curses, "wrapper", wrapper)
    monkeypatch.setattr(curses, "use_default_colors", lambda: None)
    return screens


def test_curses_view_draws_frames_until_done(tmp_path, stub_curses):
    cfg, soak = _soak(tmp_path, "all")
    scr = StubScreen(h=12, w=60)
    stub_curses.append(scr)
    frames_seen = []
    real_frame = dash.frame

    def spy(s):
        out = real_frame(s)
        frames_seen.append(out)
        return out

    dash.frame, saved = spy, dash.frame
    try:
        dash.run_curses(soak, CHUNK, CHUNK, 1, cfg)
    finally:
        dash.frame = saved
    assert soak.done and scr.nodelay_set is True
    assert len(scr.frames) == len(frames_seen) >= 2
    assert soak.injections  # the spine went in at the first chunk boundary
    for drawn, lines in zip(scr.frames, frames_seen):
        body = [ln[: scr.w - 1] for ln in lines[: scr.h - 1]]
        assert drawn == body + ["q: quit (checkpoints kept)"]
    assert frames_seen[-1][0].startswith(f"soak cursor {soak.cursor}/{soak.horizon}")


def test_q_quits_with_checkpoints_kept(tmp_path, stub_curses):
    cfg, soak = _soak(tmp_path, "quit")
    scr = StubScreen(keys=[ord("q")])
    stub_curses.append(scr)
    dash.run_curses(soak, CHUNK, None, 1, cfg)
    assert len(scr.frames) == 1 and not soak.done
    assert soak.cursor == CHUNK
    assert latest(str(tmp_path / "quit")) is not None  # the chunk's checkpoint stays


def test_plain_flag_and_non_terminal_keep_the_plain_view(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(dash, "run_curses", lambda *a: calls.append("curses"))
    monkeypatch.setattr(dash, "run_plain", lambda *a: calls.append("plain"))
    args = ["--ticks", str(TICKS), "--chunk", str(CHUNK), "--trace", "0", "--device", "cpu"]
    dash.main(["--plain", *args])
    monkeypatch.setattr("sys.stdout.isatty", lambda: True)
    dash.main(args)
    assert calls == ["plain", "curses"]
    assert "finished at cursor" in capsys.readouterr().out
