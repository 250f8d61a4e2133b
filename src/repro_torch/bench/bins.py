"""The balls-into-bins figures (the reference's ``benchmarks/fig13_balls_bins.py``,
``fig16_evs_imbalance.py`` and ``fig17_coalesced_bins.py``) on the port's
``repro_torch.core.balls_bins``:

* fig13 / fig14 (Theorem 5.1): batched balls-into-bins (OPS, lambda 0.99)
  against recycled balls-into-bins at n in {8, 32, 128}, 10,000 steps at
  paper scale (4,000 otherwise);
* fig16 (Appendix B): the EV-space load imbalance at a 32-uplink switch,
  flows {1, 32} x EVS 2^{4, 8, 12, 16}, 64 trials;
* fig17 (Appendix D.1): recycled bins at n = 32, 4,000 steps, under
  coalescing ratios 1, 2, 4, 8, and OPS at lambda 1.0.

Each cell's ``us_per_call`` is its wall time on the device, synchronized.

    python -m repro_torch.bench.run --only bins [--full] [--device cpu]
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch.bench.common import Rows
from repro_torch.core.balls_bins import evs_load_imbalance, simulate_ops_bins, simulate_recycled_bins
from repro_torch.device import resolve_device

NS = (8, 32, 128)  # fig13 / fig14 bins
FIG16 = tuple((flows, bits) for flows in (1, 32) for bits in (4, 8, 12, 16))  # flows x EVS 2^bits
FIG16_PORTS, FIG16_TRIALS = 32, 64
FIG17_N, FIG17_STEPS, FIG17_RATIOS = 32, 4000, (1, 2, 4, 8)
PARTS = ("fig13", "fig16", "fig17")


def _timed(dev, fn):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e6


def params(n: int) -> tuple[int, int]:
    """``(b, tau)`` of the recycled process at n bins, as the reference's."""
    return int(np.ceil(2.4 * np.log(n))), int(4 * np.log(n))


def cells(dev, steps: int, parts=PARTS, fig16_trials=lambda m: FIG16_TRIALS) -> list:
    """The cells of the figures in ``parts`` as ``(key, run)`` pairs, in
    order; ``run()`` computes the cell on ``dev`` from key 0.  Keys:
    ``("ops", n)`` and ``("rec", n)`` (fig13 / fig14, ``steps`` steps),
    ``("evs", flows, bits)`` (fig16, ``fig16_trials(flows * 2**bits)``
    trials), ``("c", ratio)`` and ``("ops17", n)`` (fig17)."""
    key = rng.PRNGKey(0, dev)
    out = []
    if "fig13" in parts:
        out += [(("ops", n), functools.partial(simulate_ops_bins, key, n, 0.99, steps, device=dev))
                for n in NS]
        out += [(("rec", n), functools.partial(simulate_recycled_bins, key, n, *params(n), steps,
                                               device=dev)) for n in NS]
    if "fig16" in parts:
        out += [(("evs", flows, bits), functools.partial(
            evs_load_imbalance, key, FIG16_PORTS, 2**bits, flows, fig16_trials(flows * 2**bits),
            device=dev)) for flows, bits in FIG16]
    if "fig17" in parts:
        n = FIG17_N
        out += [(("c", ratio), functools.partial(simulate_recycled_bins, key, n, *params(n),
                                                 FIG17_STEPS, coalesce=ratio, device=dev))
                for ratio in FIG17_RATIOS]
        out.append((("ops17", n), functools.partial(simulate_ops_bins, key, n, 1.0, FIG17_STEPS,
                                                    device=dev)))
    return out


def _row(key, out, steps: int) -> tuple[str, str]:
    """A cell's row name and derived fields."""
    kind = key[0]
    if kind == "ops":
        ml = out.cpu().numpy()
        return f"fig13/ops/n{key[1]}", f"max_load_end={ml[-1]};peak={ml.max()};steps={steps}"
    if kind == "rec":
        return (f"fig14/recycled/n{key[1]}", f"max_load_end={int(out.max_load[-1])};"
                f"tau={params(key[1])[1]};frac_remember={float(out.frac_remember[-1]):.3f}")
    if kind == "evs":
        lam = out.cpu().numpy()
        return (f"fig16/flows{key[1]}/evs2^{key[2]}",
                f"mean_imbalance={lam.mean():.4f};p95={np.percentile(lam, 95):.4f}")
    if kind == "c":
        return (f"fig17/recycled_c{key[1]}",
                f"max_load_end={int(out.max_load[-1])};tau={params(FIG17_N)[1]}")
    return "fig17/ops_reference", f"max_load_end={int(out[-1])}"


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    dev = resolve_device(device)
    steps = 10000 if full else 4000
    for key, run in cells(dev, steps):
        out, us = _timed(dev, run)
        name, derived = _row(key, out, steps)
        rows.add(name, us, derived)
    return rows
