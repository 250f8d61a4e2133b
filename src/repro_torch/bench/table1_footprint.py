"""Table 1: per-connection memory footprint of REPS (the reference's
``benchmarks/table1_footprint.py``).

Two modes:

* default: the paper's arithmetic footprint (``state_footprint_bits``) for
  1- and 8-deep buffers, ``table1/buffer{n}`` rows;
* ``conns=N`` (scale mode): measured end to end.  N connections of REPS
  state are made on the device, perturbed from a numpy seed (the
  reference's values), bit-packed into the Table 1 layout
  (``reps.pack_state``) and round-tripped; the row
  ``scale/footprint_conns{N}`` gives the packed bytes per connection, which
  must be <= 25 (the paper's claim; asserted).

    python -m repro_torch.bench.run --only table1 --scale-conns 1000000
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.common import Rows
from repro_torch.core.reps import (
    REPSConfig, init_state, pack_state, state_footprint_bits, unpack_state,
)
from repro_torch.device import resolve_device

PAPER_BYTES_PER_CONN = 25
CHECKED = ("buf_ev", "buf_valid", "head", "num_valid", "explore_counter", "is_freezing",
           "exit_freezing")


def check_roundtrip(cfg: REPSConfig, state) -> float:
    """Pack ``state`` (a ``REPSState`` of any device), unpack it and hold
    every field the algorithm reads against the original (``n_cached``
    comes back as its ``> 0`` bit, the only one read); returns the packed
    bytes per connection."""
    packed = pack_state(cfg, state)
    back = unpack_state(cfg, packed, device="cpu")
    for f in CHECKED:
        if not torch.equal(getattr(back, f), getattr(state, f).cpu()):
            raise AssertionError(f"round-trip mismatch: {f}")
    if not torch.equal(back.n_cached, (state.n_cached.cpu() > 0).to(torch.int32)):
        raise AssertionError("round-trip mismatch: n_cached indicator")
    return packed.nbytes / packed.shape[0]


def measure_scale(n_conns: int, rows: Rows, buffer_size: int = 8, device=None) -> float:
    """Make, perturb, bit-pack and round-trip ``n_conns`` connections of
    REPS state on ``device`` (the card by default); add a
    ``scale/footprint_conns{N}`` row and return the bytes per connection."""
    dev = resolve_device(device)
    cfg = REPSConfig(buffer_size=buffer_size)
    t0 = time.time()
    state = init_state(cfg, n_conns, device=dev)
    # every field perturbed as the reference perturbs it, so the round trip
    # sees real bit patterns, not the all-zero init
    rng = np.random.default_rng(0)
    on = lambda a: torch.as_tensor(a, device=dev)
    state = state.replace(
        buf_ev=state.buf_ev + on(rng.integers(0, cfg.evs_size, state.buf_ev.shape,
                                              dtype=np.int32)),
        buf_valid=on(rng.integers(0, 2, tuple(state.buf_valid.shape)).astype(bool)),
        head=state.head + on(rng.integers(0, buffer_size, (n_conns,), dtype=np.int32)),
        num_valid=state.num_valid + on(rng.integers(0, buffer_size + 1, (n_conns,),
                                                    dtype=np.int32)),
        is_freezing=on(rng.integers(0, 2, (n_conns,)).astype(bool)),
        exit_freezing=state.exit_freezing + on(rng.integers(0, 1 << 20, (n_conns,),
                                                            dtype=np.int32)),
        n_cached=state.n_cached + on(rng.integers(0, 2, (n_conns,), dtype=np.int32)),
    )
    bytes_per_conn = check_roundtrip(cfg, state)
    wall = time.time() - t0
    if bytes_per_conn > PAPER_BYTES_PER_CONN:
        raise AssertionError(f"measured {bytes_per_conn:.3f} B/conn exceeds the paper's "
                             f"{PAPER_BYTES_PER_CONN} B/conn claim")
    rows.add(f"scale/footprint_conns{n_conns}", wall * 1e6,
             f"bytes_per_conn={bytes_per_conn:.3f};"
             f"packed_mb={bytes_per_conn * n_conns / 1e6:.1f};roundtrip=ok",
             bytes_per_conn=bytes_per_conn)
    return bytes_per_conn


def main(rows=None, conns: int | None = None, device=None, **_):
    rows = rows or Rows()
    for n in [1, 8]:
        t0 = time.time()
        fp = state_footprint_bits(REPSConfig(buffer_size=n))
        rows.add(f"table1/buffer{n}", (time.time() - t0) * 1e6,
                 f"total_bits={fp['total_bits']};bytes={fp['total_bytes_ceil']}")
    if conns:
        bpc = measure_scale(conns, rows, device=device)
        print(f"# scale mode: {conns} conns packed at {bpc:.3f} B/conn "
              f"(paper claim <= {PAPER_BYTES_PER_CONN})")
    return rows
