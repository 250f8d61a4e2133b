# Frozen copy of the port's plain formulation (src/repro_torch/core/reps.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""REPS — Recycled Entropy Packet Spraying (counterpart of
``repro.core.reps``): the paper's Algorithms 1 and 2 as branch-free tensor
updates over a batch of connections, plus the scalar oracle that pins them
to the pseudocode.

Per-connection state (paper Table 1, ~25 bytes with an 8-deep buffer): a
circular buffer of ``buffer_size`` cached entropy values (EVs) with validity
bits, the ``head`` pointer, ``num_valid``, ``explore_counter`` (one BDP of
packets at start), the freezing flag and its exit deadline.

Semantics, as in the reference:
  * ``on_ack`` (Alg. 1): ECN-marked ACKs are discarded.  A clean ACK's EV is
    written at ``head`` (overwriting), marked valid, and ``head`` advances.
    Freezing ends on a clean ACK with ``now > exit_freezing``, and then
    ``explore_counter`` is re-armed to one BDP.
  * ``on_failure_detection`` (Alg. 1): enter freezing only when not already
    freezing and not in the warm-up explore phase.
  * ``choose_ev`` (Alg. 2): explore a uniform EV when the buffer was never
    written, when nothing is valid and we are not freezing, or while
    ``explore_counter > 0``; otherwise pop the *oldest valid* EV (offset
    ``head - num_valid``) — or, freezing with nothing valid, reuse the entry
    at ``head`` even if invalid and advance ``head``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng
from .device import resolve_device

DEFAULT_BUFFER_SIZE = 8  # paper §3.1: chosen from Theorem 5.1 bounds


@dataclasses.dataclass(frozen=True)
class REPSConfig:
    buffer_size: int = DEFAULT_BUFFER_SIZE
    evs_size: int = 65536  # 16-bit EV space (§2.2)
    num_pkts_bdp: int = 32  # warm-up explore budget
    freezing_timeout: int = 1024  # ticks (§3.2)


@dataclasses.dataclass(frozen=True)
class REPSState:
    """Structure of arrays over N connections (dtypes as in the reference)."""

    buf_ev: torch.Tensor  # (N, B) int32 cached EVs
    buf_valid: torch.Tensor  # (N, B) bool validity bits
    head: torch.Tensor  # (N,) int32
    num_valid: torch.Tensor  # (N,) int32
    explore_counter: torch.Tensor  # (N,) int32
    is_freezing: torch.Tensor  # (N,) bool
    exit_freezing: torch.Tensor  # (N,) int32 tick deadline
    n_cached: torch.Tensor  # (N,) int32 total EVs ever cached (isEmpty check)

    def replace(self, **kw) -> "REPSState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(REPSState))


def init_state(cfg: REPSConfig, n_conns: int, device=None) -> REPSState:
    dev = resolve_device(device)
    B, i32 = cfg.buffer_size, torch.int32
    return REPSState(
        buf_ev=torch.zeros((n_conns, B), dtype=i32, device=dev),
        buf_valid=torch.zeros((n_conns, B), dtype=torch.bool, device=dev),
        head=torch.zeros((n_conns,), dtype=i32, device=dev),
        num_valid=torch.zeros((n_conns,), dtype=i32, device=dev),
        explore_counter=torch.full((n_conns,), cfg.num_pkts_bdp, dtype=i32, device=dev),
        is_freezing=torch.zeros((n_conns,), dtype=torch.bool, device=dev),
        exit_freezing=torch.zeros((n_conns,), dtype=i32, device=dev),
        n_cached=torch.zeros((n_conns,), dtype=i32, device=dev),
    )


def _lane_is(idx: torch.Tensor, B: int) -> torch.Tensor:
    """(N, B) bool one-hot of ``idx`` (the reference's ``jax.nn.one_hot``)."""
    return torch.arange(B, dtype=idx.dtype, device=idx.device) == idx[:, None]


def on_ack(cfg: REPSConfig, state: REPSState, mask, ev, ecn, now) -> REPSState:
    """Paper Algorithm 1, onAck — vectorized over connections."""
    B = cfg.buffer_size
    cache = mask & ~ecn  # ECN-marked ACKs are discarded (Alg.1 l.6-8)
    at_head = _lane_is(state.head, B)
    slot_was_valid = (state.buf_valid & at_head).any(dim=1)
    num_valid = torch.where(cache & ~slot_was_valid, state.num_valid + 1, state.num_valid)
    write = cache[:, None] & at_head
    buf_ev = torch.where(write, ev[:, None], state.buf_ev)
    buf_valid = state.buf_valid | write
    head = torch.where(cache, (state.head + 1) % B, state.head)
    n_cached = torch.where(cache, state.n_cached + 1, state.n_cached)
    # freezing-mode exit (Alg.1 l.15-18), reached only on a clean cached ACK
    exit_now = cache & state.is_freezing & (now > state.exit_freezing)
    return REPSState(
        buf_ev=buf_ev,
        buf_valid=buf_valid,
        head=head,
        num_valid=num_valid,
        explore_counter=torch.where(exit_now, cfg.num_pkts_bdp, state.explore_counter),
        is_freezing=state.is_freezing & ~exit_now,
        exit_freezing=state.exit_freezing,
        n_cached=n_cached,
    )


def on_failure_detection(cfg: REPSConfig, state: REPSState, mask, now) -> REPSState:
    """Paper Algorithm 1, onFailureDetection — enter freezing mode."""
    enter = mask & ~state.is_freezing & (state.explore_counter == 0)
    return state.replace(
        is_freezing=state.is_freezing | enter,
        exit_freezing=torch.where(enter, now + cfg.freezing_timeout, state.exit_freezing),
    )


def draw_evs(cfg: REPSConfig, key: torch.Tensor, n: int) -> torch.Tensor:
    """The uniform EVs ``choose_ev`` explores with: ``randint(key, (n,), 0,
    evs_size)`` — batched over the key's leading axes like every draw."""
    return rng.randint(key, (n,), 0, cfg.evs_size)


def choose_ev(
    cfg: REPSConfig, state: REPSState, mask, key=None, *, rand_ev=None
) -> tuple[torch.Tensor, REPSState]:
    """Paper Algorithm 2 (onSend + getNextEV) — vectorized.

    The explore EVs come from ``key`` exactly as the reference draws them,
    or ready-drawn as ``rand_ev`` (the engine draws a chunk of ticks at
    once).  Returns (evs, new_state); ``evs[i]`` matters only where
    ``mask[i]``.
    """
    N, B = state.buf_ev.shape
    if rand_ev is None:
        rand_ev = draw_evs(cfg, key, N)
    explore = mask & (
        (state.n_cached == 0)
        | ((state.num_valid == 0) & ~state.is_freezing)
        | (state.explore_counter > 0)
    )
    recycle = mask & ~explore  # take from the buffer
    # branch 1: pop the oldest valid entry; branch 2 (freezing, nothing
    # valid): reuse the entry at head and advance head
    pop_valid = recycle & (state.num_valid > 0)
    reuse = recycle & (state.num_valid == 0)
    offset = torch.where(pop_valid, (state.head - state.num_valid) % B, state.head)
    at_off = _lane_is(offset, B)
    picked = torch.where(at_off, state.buf_ev, 0).sum(dim=1, dtype=torch.int32)
    evs = torch.where(recycle, picked, rand_ev)
    new_state = state.replace(
        buf_valid=state.buf_valid & ~(pop_valid[:, None] & at_off),
        num_valid=torch.where(pop_valid, state.num_valid - 1, state.num_valid),
        head=torch.where(reuse, (state.head + 1) % B, state.head),
        explore_counter=torch.where(
            explore, torch.clamp(state.explore_counter - 1, min=0), state.explore_counter
        ),
    )
    return evs, new_state


def state_footprint_bits(cfg: REPSConfig) -> dict[str, int]:
    """Paper Table 1: per-connection memory footprint in bits."""
    per_element = 16 + 1  # cachedEV + isValid
    globals_bits = {
        "head": 8,
        "numberOfValidEVs": 8,
        "exitFreezingMode": 32,
        "isFreezingMode": 1,
        "exploreCounter": 8,
    }
    total = per_element * cfg.buffer_size + sum(globals_bits.values())
    return {
        "per_buffer_element_bits": per_element,
        "buffer_elements": cfg.buffer_size,
        **{f"global_{k}_bits": v for k, v in globals_bits.items()},
        "total_bits": total,
        "total_bytes_ceil": (total + 7) // 8,
    }


def pack_state(cfg: REPSConfig, state: REPSState) -> np.ndarray:
    """Bit-pack a REPSState into the Table 1 layout, one ``(N,
    total_bytes_ceil)`` uint8 row per connection (25 bytes at the default
    depth), byte-identical to the reference's ``pack_state``.  Beyond Table
    1 it keeps one ``ever_cached`` bit, because ``n_cached`` is only ever
    read as ``n_cached == 0``; ``unpack_state`` returns that bit as
    ``n_cached``."""
    B = cfg.buffer_size
    if cfg.evs_size > 1 << 16:
        raise ValueError("EV does not fit the 16-bit field")
    if B >= 256 or cfg.num_pkts_bdp >= 256:
        raise ValueError("8-bit counters overflow")
    host = {f: getattr(state, f).cpu().numpy() for f in FIELDS}
    n = host["head"].shape[0]

    def bits(vals, width):  # (N,) uint -> (N, width) little-endian bits
        v = np.asarray(vals, np.int64).astype(np.uint32)
        return (v[:, None] >> np.arange(width, dtype=np.uint32)) & 1

    cols = []
    for b in range(B):
        cols.append(bits(host["buf_ev"][:, b], 16))
        cols.append(host["buf_valid"][:, b : b + 1].astype(np.uint32))
    cols += [
        bits(host["head"], 8),
        bits(host["num_valid"], 8),
        bits(host["exit_freezing"].astype(np.int64) & 0xFFFFFFFF, 32),
        host["is_freezing"].astype(np.uint32).reshape(n, 1),
        bits(host["explore_counter"], 8),
        (host["n_cached"] > 0).astype(np.uint32).reshape(n, 1),
    ]
    stream = np.concatenate(cols, axis=1).astype(np.uint8)
    return np.packbits(stream, axis=1, bitorder="little")


def unpack_state(cfg: REPSConfig, packed: np.ndarray, device=None) -> REPSState:
    """Inverse of ``pack_state`` (``n_cached`` comes back as 0 or 1)."""
    B = cfg.buffer_size
    total = state_footprint_bits(cfg)["total_bits"] + 1
    stream = np.unpackbits(packed, axis=1, bitorder="little")[:, :total]
    pos = 0

    def take(width):
        nonlocal pos
        chunk = stream[:, pos : pos + width].astype(np.uint32)
        pos += width
        return (chunk << np.arange(width, dtype=np.uint32)).sum(axis=1, dtype=np.uint32)

    n = packed.shape[0]
    buf_ev = np.empty((n, B), np.int32)
    buf_valid = np.empty((n, B), bool)
    for b in range(B):
        buf_ev[:, b] = take(16).astype(np.int32)
        buf_valid[:, b] = take(1).astype(bool)
    fields = dict(
        buf_ev=buf_ev,
        buf_valid=buf_valid,
        head=take(8).astype(np.int32),
        num_valid=take(8).astype(np.int32),
        exit_freezing=take(32).astype(np.int32),
        is_freezing=take(1).astype(bool),
        explore_counter=take(8).astype(np.int32),
        n_cached=take(1).astype(np.int32),
    )
    dev = resolve_device(device)
    return REPSState(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})


class REPSOracle:
    """Scalar pure-Python oracle transcribing the paper's pseudocode."""

    def __init__(self, cfg: REPSConfig):
        self.cfg = cfg
        B = cfg.buffer_size
        self.buf_ev = [0] * B
        self.buf_valid = [False] * B
        self.head = 0
        self.num_valid = 0
        self.explore_counter = cfg.num_pkts_bdp
        self.is_freezing = False
        self.exit_freezing = 0
        self.n_cached = 0

    def on_ack(self, ev: int, ecn: bool, now: int) -> None:
        if ecn:
            return
        if not self.buf_valid[self.head]:
            self.num_valid += 1
        self.buf_ev[self.head] = ev
        self.buf_valid[self.head] = True
        self.head = (self.head + 1) % self.cfg.buffer_size
        self.n_cached += 1
        if self.is_freezing and now > self.exit_freezing:
            self.is_freezing = False
            self.explore_counter = self.cfg.num_pkts_bdp

    def on_failure_detection(self, now: int) -> None:
        if not self.is_freezing and self.explore_counter == 0:
            self.is_freezing = True
            self.exit_freezing = now + self.cfg.freezing_timeout

    def _get_next_ev(self) -> int:
        B = self.cfg.buffer_size
        if self.num_valid > 0:
            offset = (self.head - self.num_valid) % B
            self.buf_valid[offset] = False
            self.num_valid -= 1
        else:  # must be in freezing mode
            offset = self.head
            self.head = (self.head + 1) % B
        return self.buf_ev[offset]

    def on_send(self, rand_ev: int) -> int:
        is_empty = self.n_cached == 0
        if (
            is_empty
            or (self.num_valid == 0 and not self.is_freezing)
            or self.explore_counter > 0
        ):
            self.explore_counter = max(self.explore_counter - 1, 0)
            return rand_ev
        return self._get_next_ev()
