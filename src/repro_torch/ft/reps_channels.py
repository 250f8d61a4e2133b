"""REPS as the cross-pod gradient-channel scheduler (counterpart of
``repro.ft.reps_channels``).

Multi-pod training reduces gradients across pods over the datacenter
Ethernet fabric (DCN), the multipath domain the paper targets.  Gradient
buckets are chunked across parallel DCN *channels* (the EV space);
per-chunk completion feedback plays the role of ACKs (a congested channel's
latency-above-threshold is the ECN analogue, which doubles as straggler
mitigation), and chunk timeouts play the role of failure detection and
trigger freezing mode.

The scheduler is the port's ``core.reps`` state machine, driving channel
choice for every chunk; only its state and key live on the device.
``ChannelSim`` models the DCN channel pool (capacities, congestion, failure
windows) in numpy, as the reference does, so the same seed gives the same
latencies and the same reports.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import reps as reps_core
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ChannelSimConfig:
    n_channels: int = 16
    base_latency_us: float = 50.0
    congestion_latency_us: float = 400.0  # when oversubscribed
    ecn_threshold_us: float = 120.0
    timeout_us: float = 1000.0
    capacity_chunks: int = 4  # chunks per channel per round at base latency


class ChannelSim:
    """Round-based DCN channel model with failure/degradation windows."""

    def __init__(self, cfg: ChannelSimConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.failed = np.zeros(cfg.n_channels, bool)
        self.degraded = np.zeros(cfg.n_channels, bool)

    def set_failed(self, channels, failed=True):
        self.failed[np.asarray(channels)] = failed

    def set_degraded(self, channels, degraded=True):
        self.degraded[np.asarray(channels)] = degraded

    def round(self, chunk_channels: np.ndarray):
        """Send one chunk per entry over its channel; returns per-chunk
        (latency_us, ecn, timed_out).  One ``rng.rand()`` per chunk that
        does not time out, in chunk order, as the reference draws them."""
        cfg = self.cfg
        counts = np.bincount(chunk_channels, minlength=cfg.n_channels)
        lat = np.empty(len(chunk_channels), np.float64)
        ecn = np.zeros(len(chunk_channels), bool)
        timeout = np.zeros(len(chunk_channels), bool)
        for i, ch in enumerate(chunk_channels):
            if self.failed[ch]:
                timeout[i] = True
                lat[i] = cfg.timeout_us
                continue
            cap = cfg.capacity_chunks // (2 if self.degraded[ch] else 1)
            load = counts[ch] / max(cap, 1)
            base = cfg.base_latency_us * (2 if self.degraded[ch] else 1)
            lat[i] = base + max(0.0, load - 1.0) * cfg.congestion_latency_us
            lat[i] *= 1.0 + 0.05 * self.rng.rand()
            ecn[i] = lat[i] > cfg.ecn_threshold_us
        return lat, ecn, timeout


class RepsChannelScheduler:
    """Drives chunk -> channel assignment with the paper's algorithm; its
    REPS state (one connection) and threefry key live on ``device`` (the
    card unless ``device="cpu"``)."""

    def __init__(
        self,
        n_channels: int,
        buffer_size: int = 8,
        num_pkts_bdp: int = 8,
        freezing_timeout_rounds: int = 4,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = reps_core.REPSConfig(
            buffer_size=buffer_size,
            evs_size=n_channels,  # the EV space IS the channel pool
            num_pkts_bdp=num_pkts_bdp,
            freezing_timeout=freezing_timeout_rounds,
        )
        self.state = reps_core.init_state(self.cfg, 1, device=self.device)
        self.key = rng.PRNGKey(seed, device=self.device)
        self.round_idx = 0
        self._mask = torch.ones((1,), dtype=torch.bool, device=self.device)

    def assign(self, n_chunks: int) -> np.ndarray:
        """Pick a channel for each chunk of this round (sequential pops from
        the REPS buffer, the send datapath of Algorithm 2): one key split
        per chunk, as the reference draws them."""
        chosen = np.empty(n_chunks, np.int32)
        for i in range(n_chunks):
            self.key, sub = rng.split(self.key)
            ev, self.state = reps_core.choose_ev(self.cfg, self.state, self._mask, sub)
            chosen[i] = int(ev[0])
        return chosen

    def feedback(self, channels: np.ndarray, ecn: np.ndarray, timeout: np.ndarray):
        """ACK/timeout ingestion (Algorithm 1) for each completed chunk."""
        now = self.round_idx
        for ch, e, to in zip(channels, ecn, timeout):
            if to:
                self.state = reps_core.on_failure_detection(self.cfg, self.state, self._mask, now)
            else:
                self.state = reps_core.on_ack(
                    self.cfg, self.state, self._mask,
                    torch.tensor([int(ch)], dtype=torch.int32, device=self.device),
                    torch.tensor([bool(e)], device=self.device),
                    now,
                )
        self.round_idx += 1

    @property
    def is_freezing(self) -> bool:
        return bool(self.state.is_freezing[0])


@dataclasses.dataclass
class ReduceReport:
    rounds: int
    total_latency_us: float
    p99_chunk_latency_us: float
    timeouts: int
    ecn_marked: int


def run_cross_pod_reduce(
    scheduler,
    sim: ChannelSim,
    n_chunks_total: int,
    chunks_per_round: int,
) -> ReduceReport:
    """Simulate a bucketed cross-pod gradient reduction: chunks stream in
    rounds; a round's makespan is its slowest chunk (collective semantics);
    timed-out chunks are retransmitted."""
    remaining = n_chunks_total
    total_lat = 0.0
    lats: list[float] = []
    timeouts = ecn_total = rounds = 0
    while remaining > 0:
        n = min(chunks_per_round, remaining)
        chans = scheduler.assign(n)
        lat, ecn, to = sim.round(chans)
        scheduler.feedback(chans, ecn, to)
        done = int(np.sum(~to))
        remaining -= done
        timeouts += int(np.sum(to))
        ecn_total += int(np.sum(ecn & ~to))
        total_lat += float(np.max(lat))
        lats.extend(lat[~to].tolist() if done else [float(np.max(lat))])
        rounds += 1
        if rounds > 100 * (n_chunks_total // chunks_per_round + 1):
            break  # safety
    return ReduceReport(
        rounds=rounds,
        total_latency_us=total_lat,
        p99_chunk_latency_us=float(np.percentile(lats, 99)) if lats else 0.0,
        timeouts=timeouts,
        ecn_marked=ecn_total,
    )


class OpsChannelScheduler:
    """Oblivious baseline: uniform random channel per chunk (numpy, as in
    the reference)."""

    def __init__(self, n_channels: int, seed: int = 0):
        self.n = n_channels
        self.rng = np.random.RandomState(seed)
        self.round_idx = 0

    def assign(self, n_chunks: int) -> np.ndarray:
        return self.rng.randint(0, self.n, n_chunks).astype(np.int32)

    def feedback(self, channels, ecn, timeout):
        self.round_idx += 1
