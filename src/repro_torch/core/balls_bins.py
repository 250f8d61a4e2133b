"""Section 5 theory models (counterpart of ``repro.core.balls_bins``):
batched balls-into-bins (OPS) and the paper's *recycled* balls-into-bins
process (Theorem 5.1), the Appendix B EVS load-imbalance model (Fig. 16)
and Appendix D.1 coalesced recycling (Fig. 17).

Keys are ``repro_torch.rng`` keys; every draw is bit-equal to the
reference's.  The reference draws step by step inside a ``lax.scan``; a
counter-based draw depends only on its key, so here every step's draws of a
run are made at once from the split keys before the step loop, which then
holds no random number generator.  The per-bin counts and the FIFO rank of
a step's arrivals are the repo's two segment kernels (``kernel_ops.seg_sum``
and ``kernel_ops.seg_rank``): the hand-written kernels on the card, their
plain versions on the CPU.

Every function runs on the card unless ``device="cpu"`` is asked for.

    tr = simulate_recycled_bins(rng.PRNGKey(0), 32, 9, 13, 4000)
    tr.max_load, tr.frac_remember, tr.loads_final
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import rng
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

I32 = torch.int32
F32 = torch.float32
TRIAL_DRAWS = 2**24  # EV draws of fig16's trials made in one pass, at most


def _key(key: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return key.to(device=dev, dtype=torch.int64)


def _f32(v: float) -> float:
    return torch.tensor(float(v), dtype=F32).item()


# ---------------------------------------------------------------------------
# OPS model: each step every non-empty bin removes one ball, then ~lam*n new
# balls are thrown uniformly at random (paper §5.1, Fig. 13 top curves).
# ---------------------------------------------------------------------------
def simulate_ops_bins(key: torch.Tensor, n_bins: int, lam: float, steps: int,
                      device=None) -> torch.Tensor:
    """Returns ``(steps,)`` int32 max bin load over time.

    Every step's arrivals are one ``seg_sum`` launch over a ``(steps,
    n_bins)`` row axis.  The per-bin recursion ``L_t = max(L_{t-1} - 1, 0) +
    a_t`` is Lindley's: with ``U_t = L_t - a_t`` and ``S_t`` the running
    sum of ``a - 1`` before step t, ``U_t = S_t - min_{k <= t} S_k``, so it
    is a ``cumsum`` and a ``cummin`` over the steps (exact in int32)."""
    dev = resolve_device(device)
    keys = rng.split(_key(key, dev), steps)  # (steps, 2)
    arrivals = rng.bernoulli(rng.fold_in(keys, 0), lam, (n_bins,))  # (steps, n)
    targets = rng.randint(rng.fold_in(keys, 1), (n_bins,), 0, n_bins)
    add = kernel_ops.seg_sum(targets, [arrivals], n_bins)[:, 0]  # (steps, n)
    s = torch.cumsum(add - 1, dim=0, dtype=I32) - (add - 1)  # S_t: the sum before step t
    u = s - torch.cummin(torch.minimum(s, torch.zeros_like(s)), dim=0).values
    return (u + add).amax(dim=1)


# ---------------------------------------------------------------------------
# Recycled balls-into-bins (paper §5.1, Theorem 5.1; Fig. 13/14 bottom).
#
#   * b*n colors cycled round-robin in batches of n.
#   * Each step every non-empty bin removes its FIFO-oldest ball.  If the
#     bin's load (pre-removal) is <= tau the removed ball's color remembers
#     the bin (unless it already remembers one); if > tau the color forgets.
#   * Each color of the current batch throws one ball into its remembered
#     bin, or uniformly at random if it has no memory.
#
# Coalesced recycling (Appendix D.1): with ratio r only every r-th removal
# feeds back into color memory; skipped removals lose their memory (their
# "ACK" never returns), modelling n:1 ACK coalescing.
# ---------------------------------------------------------------------------
class RecycledTrace(NamedTuple):
    max_load: torch.Tensor  # (steps,) int32
    frac_remember: torch.Tensor  # (steps,) float32 fraction of colors w/ memory
    loads_final: torch.Tensor  # (n_bins,) int32


def simulate_recycled_bins(
    key: torch.Tensor,
    n_bins: int,
    b: int,
    tau: int,
    steps: int,
    queue_cap: int = 0,
    coalesce: int = 1,
    device=None,
) -> RecycledTrace:
    """The reference's process, step by step on the device; every step's
    random bins are drawn before the loop.  Per step one ``seg_rank``
    launch ranks the arrivals within their target bin and one ``seg_sum``
    launch counts them per bin.

    Two writes of the reference are scatters with repeated indices, which
    XLA:CPU applies in update order (the last update wins) and
    ``index_put_`` leaves undefined.  Both are resolved here before the
    write, so that every index is written once:

    * the memory update writes one value per bin at the color the bin
      removed, and two bins can hold one color (an empty bin reads the stale
      color of its head slot): the highest bin id wins;
    * the enqueue writes ``queue[target, slot]``, and a bin that takes more
      than ``cap`` balls in one step wraps onto its own slots: of balls with
      one slot, the one of highest rank (the last) wins.
    """
    dev = resolve_device(device)
    n = int(n_bins)
    n_colors = int(b) * n
    cap = queue_cap if queue_cap > 0 else max(8 * tau, 64)

    keys = rng.split(_key(key, dev), steps)
    rand_bins = rng.randint(keys, (n,), 0, n)  # (steps, n): every step's draw
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    # every step's batch of colours, round-robin: (t * n + i) % n_colors
    batches = (torch.arange(steps, dtype=torch.int64, device=dev)[:, None] * n
               + lane) % n_colors

    # the queue's row n and the memory's entry n_colors are sentinels that
    # take the writes a step discards
    # colours and the head index as int64, the index type, so that no step
    # converts them
    queue = torch.zeros((n + 1, cap), dtype=torch.int64, device=dev)
    q_head = torch.zeros((n,), dtype=torch.int64, device=dev)
    q_len = torch.zeros((n,), dtype=I32, device=dev)
    color_bin = torch.full((n_colors + 1,), -1, dtype=I32, device=dev)  # -1 = no memory
    removal_seq = torch.zeros((), dtype=I32, device=dev)
    bin_ids = torch.arange(n, dtype=I32, device=dev)
    bins64 = lane
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    no_winner = torch.full((n_colors,), -1, dtype=torch.int64, device=dev)
    # jnp.mean of the float32 0/1 memory flags: the count is exact in float32
    # (n_colors < 2**24) and XLA:CPU multiplies it by the float32 reciprocal
    rcp = _f32(1.0 / _f32(n_colors))
    max_load, remembered = [], []

    for t in range(steps):
        # --- removal phase ------------------------------------------------
        nonempty = q_len > 0
        removed = queue[bins64, q_head % cap]  # int64 colour ids
        load_pre = q_len
        ne = nonempty.to(I32)
        q_head = q_head + ne
        q_len = q_len - ne

        # coalescing: only every `coalesce`-th removal (per global
        # sequence) feeds memory (every removal at 1)
        if coalesce == 1:
            feeds = nonempty
        else:
            seq_ids = removal_seq + torch.cumsum(nonempty, 0, dtype=I32) - 1
            feeds = nonempty & (seq_ids % coalesce == 0)
            removal_seq = removal_seq + nonempty.sum(dtype=I32)

        remembers = color_bin[removed]
        new_mem = torch.where(load_pre > tau, -1, torch.where(remembers < 0, bin_ids, remembers))
        val = torch.where(feeds, new_mem, remembers)
        winner = no_winner.scatter_reduce(0, removed, bins64, "amax", include_self=True)
        color_bin[torch.where(winner[removed] == bins64, removed, n_colors)] = val

        # --- arrival phase: batch of n colors, round-robin ----------------
        batch = batches[t]
        mem = color_bin[batch]
        targets = torch.where(mem >= 0, mem, rand_bins[t])
        rank = kernel_ops.seg_rank(targets, n)
        count = kernel_ops.seg_sum(targets, [ones], n)[0]
        t64 = targets.long()
        slot = ((q_head + q_len)[t64] + rank) % cap
        last = rank >= count[t64] - cap  # no later ball of its bin takes its slot
        queue[torch.where(last, t64, n), slot] = batch
        q_len = q_len + count

        max_load.append(q_len.max())
        remembered.append((color_bin[:n_colors] >= 0).sum(dtype=I32))

    frac = torch.stack(remembered).to(F32) * rcp
    return RecycledTrace(max_load=torch.stack(max_load), frac_remember=frac, loads_final=q_len)


# ---------------------------------------------------------------------------
# Appendix B (Fig. 16): EVS load imbalance under uniform hashing.
# m = flows * evs_size distinct (flow, EV) pairs hashed onto n uplinks.
# ---------------------------------------------------------------------------
def evs_load_imbalance(key: torch.Tensor, n_ports: int, evs_size: int, n_flows: int,
                       n_trials: int, device=None) -> torch.Tensor:
    """Returns ``(n_trials,)`` float32 load imbalance ``max_load / (m / n) -
    1``.  The trials are rows of one ``seg_sum`` launch, drawn and counted
    in chunks of at most ``TRIAL_DRAWS`` draws (at fig16's largest case, m
    = 2**21 per trial, 8 trials a chunk)."""
    dev = resolve_device(device)
    m = int(evs_size) * int(n_flows)
    keys = rng.split(_key(key, dev), n_trials)
    # float32(max) / float32(m / n) as the reference's weakly typed divisor
    mean = torch.tensor(m / n_ports, dtype=F32, device=dev)
    per = max(1, TRIAL_DRAWS // max(m, 1))
    out = []
    for c0 in range(0, n_trials, per):
        ports = rng.randint(keys[c0:c0 + per], (m,), 0, n_ports)  # (rows, m)
        ones = torch.ones(ports.shape, dtype=torch.bool, device=dev)
        loads = kernel_ops.seg_sum(ports, [ones], n_ports)[:, 0]
        out.append(loads.amax(dim=1).to(F32) / mean - 1.0)
    return torch.cat(out)
