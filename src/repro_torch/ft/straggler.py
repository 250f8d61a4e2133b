"""Straggler mitigation: the REPS cache-good-paths insight applied to slow
workers/channels (the port's copy of ``repro.ft.straggler``, numpy only).

A straggling DCN channel (or a slow host NIC behind it) manifests as
persistently ECN-marked (latency-above-threshold) chunk completions; the
REPS scheduler simply stops recycling it — no explicit blacklist, no per-
channel statistics (paper §3.3: track only good paths).  This module adds
the monitoring half: an EWMA latency tracker that converts completion
latencies into the ECN analogue fed to RepsChannelScheduler, plus step-time
watchdogs for the training loop.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class LatencyECN:
    """Maps per-chunk latencies to ECN marks via an adaptive threshold."""
    factor: float = 1.5  # mark if latency > factor * EWMA
    alpha: float = 0.1
    ewma_us: float = 0.0

    def mark(self, latencies_us: np.ndarray) -> np.ndarray:
        out = np.zeros(len(latencies_us), bool)
        for i, l in enumerate(latencies_us):
            if self.ewma_us == 0.0:
                self.ewma_us = float(l)
            out[i] = l > self.factor * self.ewma_us
            self.ewma_us = (1 - self.alpha) * self.ewma_us + self.alpha * float(l)
        return out


@dataclasses.dataclass
class StepWatchdog:
    """Detects straggling steps (e.g. a failing host slowing the collective)
    and reports when recovery action (freeze + re-route, checkpoint restart)
    should fire."""
    factor: float = 3.0
    alpha: float = 0.2
    ewma_s: float = 0.0
    slow_steps: int = 0
    trigger_after: int = 3

    def observe(self, step_seconds: float) -> bool:
        if self.ewma_s == 0.0:
            self.ewma_s = step_seconds
        slow = step_seconds > self.factor * self.ewma_s
        self.slow_steps = self.slow_steps + 1 if slow else 0
        self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * step_seconds
        return self.slow_steps >= self.trigger_after


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.seconds = time.time() - self.t0
