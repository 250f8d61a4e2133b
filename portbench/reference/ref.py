# Frozen copy of the port's plain formulation (src/repro_torch/kernels/ref.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""Plain PyTorch versions of the seven hand-written kernels.

Each ``<name>_ref`` computes exactly what the CUDA kernel behind
``repro_torch.kernels.<name>`` must produce, and follows the reference's
oracle in ``repro.kernels.ref``.  They run on the CPU wherever the engine's
kernel path meets a CPU tensor, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  All take an optional leading row
axis ``B`` like the kernels do.
"""
from __future__ import annotations

import torch

from . import reps as reps_core
from .kshapes import check_nports
from .kshapes import RouteGeometry, check_geometry
from .kshapes import RouteTables
from .kshapes import ack_rounds
from .rng import M32, _mulmod32


# ---------------------------------------------------------------------------
def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3-style 32-bit finalizer; uint32 words in int64 lanes (see
    ``repro_torch.rng`` for why), bit-equal to the reference's uint32."""
    x = x.to(torch.int64) & M32
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def ecmp_hash_ref(flow: torch.Tensor, ev: torch.Tensor, salt: torch.Tensor,
                  nports) -> torch.Tensor:
    """Port in ``[0, nports)`` for each (flow, EV, salt), as int32:
    ``mix32(flow*0x9E3779B1 ^ ev*0x85EBCA77 ^ salt*0xC2B2AE3D) % nports``
    in wrapping uint32 arithmetic.  Any shape; the three inputs broadcast,
    and so does ``nports`` when it is an integer tensor of per-lane port
    counts (the reference's ``jnp.asarray(nports, jnp.uint32)``).  Every
    lane must be ``>= 1``: checked here for CPU tensors, where reading them
    costs no device sync; on the card it is the caller's contract, as for
    the kernel."""
    nports = check_nports(nports)
    if isinstance(nports, torch.Tensor):
        nports = nports.to(torch.int64)
        if nports.device.type == "cpu" and bool((nports < 1).any()):
            raise ValueError("ecmp_hash needs nports >= 1 in every lane")
    u = lambda t: t.to(torch.int64) & M32
    h = mix32(
        _mulmod32(u(flow), 0x9E3779B1)
        ^ _mulmod32(u(ev), 0x85EBCA77)
        ^ _mulmod32(u(salt), 0xC2B2AE3D)
    )
    return (h % nports).to(torch.int32)


def next_queue_ref(g: RouteGeometry, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                   adaptive: bool, q_penalty=None, a_idx=None, n_pkt: int = 0) -> torch.Tensor:
    """The queue each arrival enters next (``repro.netsim.topology``'s
    ``Topology.next_queue``), int32 ``(K,)``, on the fat tree of layout ``g``.

    Reference form (``a_idx`` None): ``at_injection`` bool ``(K,)`` (the
    packet leaves its source host), ``cur_queue`` the queue just left (-1
    at injection), ``flow_id``, ``ev``, and the ``src`` / ``dst`` host of
    each arrival, all int32 ``(K,)``.  Engine form (``a_idx`` given, the
    arrivals' packet slots): ``at_injection``, ``cur_queue``, ``flow_id``
    (the connection) and ``ev`` are the gathered packet rows (hop count,
    current queue, connection, EV), ``src`` / ``dst`` the ``(NC,)``
    connection tables; slots ``>= n_pkt`` are no arrival and get
    ``n_queues``.

    Rows: the arrivals may carry a leading row axis ``(B, K)`` (a fleet of
    runs); ``q_len`` is then ``(B, n_queues)``, ``q_penalty`` ``(n_queues,)``
    shared or ``(B, n_queues)``, and the engine form's connection tables
    ``(NC,)`` shared (one workload) or ``(B, NC)`` (one per row).  Row ``b``
    is the one-row call on row ``b``'s inputs.

    Each choice hop (the ToR uplink; on 3 tiers also the agg uplink) takes
    the ECMP hash of (flow, EV, salt) with salt ``src_tor`` (agg uplink:
    ``agg_global + 7919``), or under ``adaptive`` the first least-loaded of
    its ports by ``q_len`` (``+ q_penalty`` when given); the reference
    computes the hash there too and overrides it.  ``//`` and ``%`` floor,
    as in JAX."""
    g = check_geometry(g)
    if a_idx is not None:  # mask the empty slots, gather the hosts
        valid = a_idx < n_pkt
        flow_id = torch.where(valid, flow_id, 0)
        ev = torch.where(valid, ev, 0)
        at_injection = torch.where(valid, at_injection, 1) == 0
        cur_queue = torch.where(valid, cur_queue, 0)
        cc = flow_id.clamp(0, src.shape[-1] - 1)
        if src.dim() == 2:  # one table per row
            cc = cc.long()
            src, dst = torch.gather(src, -1, cc), torch.gather(dst, -1, cc)
        else:
            src, dst = src[cc], dst[cc]
    if adaptive and q_penalty is not None:
        q_len = q_len + q_penalty
    dev = cur_queue.device
    H = g.hosts_per_tor
    src_tor, dst_tor = src // H, dst // H
    same_tor = src_tor == dst_tor
    t0_down = g.t0_down_base + dst_tor * H + dst % H

    def choose(base, n, salt):  # the port a choice hop takes among n from base
        if not adaptive:
            return ecmp_hash_ref(flow_id, ev, salt, n)
        cand = base[..., None] + torch.arange(n, dtype=torch.int32, device=dev)
        lens = torch.gather(q_len, -1, cand.flatten(-2).long()).view(cand.shape)
        return torch.argmin(lens, dim=-1).to(torch.int32)

    if g.tiers == 2:
        U = g.uplinks_per_tor
        up_base = g.t0_up_base + src_tor * U
        t0_up = up_base + choose(up_base, U, src_tor)
        at_t0_up = cur_queue < g.core_down_base
        spine = torch.where(at_t0_up, cur_queue - g.t0_up_base, 0) % U
        sp_down = g.core_down_base + spine * g.n_tors + dst_tor
        nxt = torch.where(
            at_injection,
            torch.where(same_tor, t0_down, t0_up),
            torch.where(at_t0_up, sp_down, t0_down),
        )
    else:
        A, U2, Tp, P = g.aggs_per_pod, g.agg_uplinks, g.tors_per_pod, g.n_pods
        src_pod, dst_pod = src_tor // Tp, dst_tor // Tp
        dst_tor_local = dst_tor % Tp
        same_pod = src_pod == dst_pod

        up_base = g.t0_up_base + src_tor * A
        t0_up = up_base + choose(up_base, A, src_tor)
        in_t0_up = cur_queue < g.agg_up_base
        agg_a = torch.where(in_t0_up, cur_queue - g.t0_up_base, 0) % A
        agg_global = src_pod * A + agg_a
        agg_base = g.agg_up_base + agg_global * U2
        agg_up = agg_base + choose(agg_base, U2, agg_global + 7919)
        agg_down_same = g.agg_down_base + agg_global * Tp + dst_tor_local

        in_agg_up = (cur_queue >= g.agg_up_base) & (cur_queue < g.core_down_base)
        rel = torch.where(in_agg_up, cur_queue - g.agg_up_base, 0)
        core = (rel // U2 % A) * U2 + rel % U2  # (p*A+a)*U2+u -> c = a*U2+u
        core_down = g.core_down_base + core * P + dst_pod

        in_core_down = (cur_queue >= g.core_down_base) & (cur_queue < g.agg_down_base)
        core_at = torch.where(in_core_down, cur_queue - g.core_down_base, 0) // P
        agg_down_x = g.agg_down_base + (dst_pod * A + core_at // U2) * Tp + dst_tor_local

        nxt = torch.where(
            at_injection,
            torch.where(same_tor, t0_down, t0_up),
            torch.where(
                in_t0_up,
                torch.where(same_pod, agg_down_same, agg_up),
                torch.where(in_agg_up, core_down,
                            torch.where(in_core_down, agg_down_x, t0_down)),
            ),
        )
    nxt = nxt.to(torch.int32)
    return nxt if a_idx is None else torch.where(valid, nxt, g.n_queues)


def next_queue_table_ref(t: RouteTables, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                         adaptive: bool, q_penalty=None, a_idx=None,
                         n_pkt: int = 0) -> torch.Tensor:
    """The queue each arrival enters next on a generated fabric
    (``repro.netsim.topology``'s ``TableTopology.next_queue``), by the
    tables ``t``: the arguments, forms and rows as ``next_queue_ref``.

    ``sw`` is the source host's ToR at injection, else the switch the
    current queue feeds (indices clipped to the tables, then ``sw`` to
    ``[0, NS)``: garbage lanes read real entries); the packet goes down
    ``down_next[sw, dst]`` when that is >= 0, else to ``up_base[sw, dst] +
    choice``, ``choice`` the ECMP hash of (flow, EV, ``salt[sw]``) over
    ``max(up_deg[sw], 1)`` ports or, under ``adaptive``, the first least of
    ``q_len`` (``+ q_penalty``) over ``t.max_up_deg`` candidates, the lanes
    at or past ``up_deg[sw]`` reading ``2**30``."""
    if a_idx is not None:  # mask the empty slots, gather the hosts
        valid = a_idx < n_pkt
        flow_id = torch.where(valid, flow_id, 0)
        ev = torch.where(valid, ev, 0)
        at_injection = torch.where(valid, at_injection, 1) == 0
        cur_queue = torch.where(valid, cur_queue, 0)
        cc = flow_id.clamp(0, src.shape[-1] - 1)
        if src.dim() == 2:  # one table per row
            cc = cc.long()
            src, dst = torch.gather(src, -1, cc), torch.gather(dst, -1, cc)
        else:
            src, dst = src[cc], dst[cc]
    if adaptive and q_penalty is not None:
        q_len = q_len + q_penalty
    NH, NQ, NS = t.n_hosts, t.n_queues, t.n_switches
    dev = cur_queue.device
    sw = torch.where(at_injection, t.host_sw[src.clamp(0, NH - 1)],
                     t.q_sw[cur_queue.clamp(0, NQ - 1)]).clamp(0, NS - 1)
    cell = sw.long() * NH + dst.clamp(0, NH - 1)
    down_q = t.down_next.reshape(-1)[cell]
    base = t.up_base.reshape(-1)[cell]
    deg = t.up_deg[sw]
    if adaptive:
        lane = torch.arange(t.max_up_deg, dtype=torch.int32, device=dev)
        cand = (base[..., None] + lane).clamp(0, NQ - 1)
        lens = torch.gather(q_len, -1, cand.flatten(-2).long()).view(cand.shape)
        lens = torch.where(lane < deg[..., None], lens, 2**30)
        choice = torch.argmin(lens, dim=-1).to(torch.int32)
    else:
        choice = ecmp_hash_ref(flow_id, ev, t.salt[sw], deg.clamp(min=1))
    nxt = torch.where(down_q >= 0, down_q, base + choice).to(torch.int32)
    return nxt if a_idx is None else torch.where(valid, nxt, NQ)


# ---------------------------------------------------------------------------
def seg_sum_ref(seg: torch.Tensor, vals, n_segments: int) -> torch.Tensor:
    """``out[..., f, s] = sum_k vals[..., f, k] * (seg[..., k] == s)``; ids
    outside ``[0, n_segments)`` fall in no bucket.  ``seg (..., K)`` and
    ``vals (..., F, K)`` int32, or a sequence of F bool / int32 fields shaped
    like ``seg`` (bools count as 0/1) -> ``(..., F, S)``.  One scatter-add
    into an extra bucket that takes the out-of-range ids (int32 addition is
    exact in any order), so memory and work follow K + S, not K x S: the
    scale mode's feedback call has S = 3 (NC + 1) ~ 3e6."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.stack([v.to(torch.int32) for v in vals], dim=-2)
    vals = vals.to(torch.int32)
    *lead, F, K = vals.shape
    idx = torch.where((seg >= 0) & (seg < n_segments), seg, n_segments).long()
    out = torch.zeros((*lead, F, n_segments + 1), dtype=torch.int32, device=seg.device)
    out.scatter_add_(-1, idx[..., None, :].expand(*lead, F, K), vals)
    return out[..., :n_segments]


def seg_rank_ref(seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Stable FIFO rank ``#{j < i : seg_j == seg_i}`` by pairwise compare;
    ids outside ``[0, n_segments)`` rank 0 (as the kernel returns them)."""
    K = seg.shape[-1]
    earlier = torch.ones((K, K), dtype=torch.bool, device=seg.device).tril(-1)
    same = seg[..., None, :] == seg[..., :, None]
    rank = (same & earlier).sum(dim=-1, dtype=torch.int32)
    in_range = (seg >= 0) & (seg < n_segments)
    return torch.where(in_range, rank, 0)


# ---------------------------------------------------------------------------
def reps_tick_ref(
    buf_ev, buf_valid, head, num_valid, explore, freezing, exit_freeze,
    n_cached, ack_mask, ack_ev, ack_ecn, timeout_mask, send_mask, rand_ev,
    now, num_pkts_bdp, freezing_timeout, trace_rows=None,
):
    """Fused tick = on_ack per ACK round -> on_failure_detection ->
    choose_ev, through ``repro_torch.core.reps``.  Masks and flags are bool
    tensors; an event class passed as ``None`` is all-zero, which makes its
    algorithm a no-op.  The ACK classes are one round's tensors or
    sequences of R rounds (``reps_update.ack_rounds``).  Returns the new
    state fields and the chosen EVs, shaped like the inputs; with
    ``trace_rows`` B also the ``(B, N_TRACE_KINDS)`` int32 decision counts
    of each row's connections, from the states around on_failure_detection
    and choose_ev (the reference's ``RepsLB.trace`` diffs)."""
    cfg = reps_core.REPSConfig(
        buffer_size=buf_ev.shape[-1],
        evs_size=2**31 - 1,  # rand_ev supplied externally
        num_pkts_bdp=int(num_pkts_bdp),
        freezing_timeout=int(freezing_timeout),
    )
    shape = head.shape
    flat = lambda t: t.reshape(-1)
    state = reps_core.REPSState(
        buf_ev=buf_ev.reshape(-1, cfg.buffer_size),
        buf_valid=buf_valid.reshape(-1, cfg.buffer_size),
        head=flat(head), num_valid=flat(num_valid),
        explore_counter=flat(explore), is_freezing=flat(freezing),
        exit_freezing=flat(exit_freeze), n_cached=flat(n_cached),
    )
    n = state.head.shape[0]
    no = torch.zeros((n,), dtype=torch.bool, device=head.device)
    zi = torch.zeros((n,), dtype=torch.int32, device=head.device)
    pick = lambda t, z: z if t is None else flat(t)
    for mask, ev, ecn in ack_rounds(ack_mask, ack_ev, ack_ecn):
        state = reps_core.on_ack(cfg, state, pick(mask, no), pick(ev, zi), pick(ecn, no), now)
    acked = state
    timeout, send = pick(timeout_mask, no), pick(send_mask, no)
    state = reps_core.on_failure_detection(cfg, state, timeout, now)
    timed = state
    ev, state = reps_core.choose_ev(cfg, state, send, rand_ev=pick(rand_ev, zi))
    b2 = lambda t: t.reshape(*shape, cfg.buffer_size)
    b1 = lambda t: t.reshape(shape)
    outs = (
        b2(state.buf_ev), b2(state.buf_valid), b1(state.head),
        b1(state.num_valid), b1(state.explore_counter), b1(state.is_freezing),
        b1(state.exit_freezing), b1(state.n_cached), b1(ev),
    )
    if trace_rows is None:
        return outs
    rows = int(trace_rows)
    if rows < 1 or n % rows:
        raise ValueError(f"reps_tick: {n} connections do not split into {rows} rows")
    hit = send & (state.num_valid < timed.num_valid)
    recycle = send & (state.head != timed.head)
    flags = torch.stack([
        hit, send & ~hit & ~recycle, recycle,
        timeout & timed.is_freezing & ~acked.is_freezing,
    ])  # hit, miss, recycle, freeze: kinds 0-3
    counts = torch.zeros((rows, 8), dtype=torch.int32, device=head.device)
    counts[:, :4] = flags.view(4, rows, n // rows).sum(dim=-1, dtype=torch.int32).T
    return (*outs, counts)


# ---------------------------------------------------------------------------
def queue_tick_ref(target, u, qlen, serve, capacity, kmin, kmax, red_rcp=None, pmax=1.0,
                   q_head=None, qcap=None, tile=128):
    """Serve-then-enqueue with FIFO ranking, tail drop and RED marking, in
    the reference kernel's ``tile``-sized arrival chunks: each chunk's insert
    positions are computed against the running occupancy (lengths at tick
    start, minus service, plus the *accepted* arrivals of earlier chunks), so
    the chunking decides ``pos`` of rejected arrivals.  ``serve=None`` serves
    nothing.  Returns ``(new_qlen, accept, mark, pos)``; ``target (..., K)``,
    ``qlen (..., Q)``.

    The mark is the reference kernel's, ``u < clamp((pos - kmin) / max(kmax
    - kmin, 1), 0, 1)`` with IEEE division, unless ``red_rcp`` is given: then
    it is the simulator's, ``u < clamp((float(pos) - kmin) * red_rcp, 0, 1) *
    pmax`` (the float32 reciprocal multiply XLA makes of the reference
    engine's division).  With ``q_head (..., Q)`` the result also holds each
    arrival's ring slot ``(q_head[target] + pos) % qcap``, ``q_head`` read as
    0 for targets outside ``[0, Q)``."""
    Q, K = qlen.shape[-1], target.shape[-1]
    dev = qlen.device
    run = qlen.to(torch.int32)
    if serve is not None:
        run = run - ((qlen > 0) & (serve == 1)).to(torch.int32)
    qs = torch.arange(Q, dtype=torch.int32, device=dev)
    # IEEE division by a tensor of the same device: a python-scalar divisor
    # lets CUDA's div kernel multiply by the reciprocal instead
    span = torch.full((), float(max(kmax - kmin, 1)), dtype=torch.float32, device=dev)
    accepts, marks, poss = [], [], []
    for s in range(0, K, tile):
        t = target[..., s : s + tile]
        onehot = (t[..., :, None] == qs).to(torch.int32)  # (..., T, Q)
        rank = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
        base = (run[..., None, :] * onehot).sum(dim=-1, dtype=torch.int32)
        pos = base + (rank * onehot).sum(dim=-1, dtype=torch.int32)
        is_real = onehot.sum(dim=-1) > 0
        accept = is_real & (pos < capacity)
        ramp = torch.clamp((pos - kmin).to(torch.float32) / span, 0.0, 1.0)
        marks.append(accept & (u[..., s : s + tile] < ramp))
        run = run + (onehot * accept[..., None]).sum(dim=-2, dtype=torch.int32)
        accepts.append(accept)
        poss.append(pos)
    accept, mark, pos = torch.cat(accepts, -1), torch.cat(marks, -1), torch.cat(poss, -1)
    if red_rcp is not None:
        mark_p = torch.clamp((pos.to(torch.float32) - kmin) * red_rcp, 0.0, 1.0) * pmax
        mark = accept & (u < mark_p)
    if q_head is None:
        return run, accept, mark, pos
    ok = (target >= 0) & (target < Q)
    head = torch.gather(q_head, -1, target.clamp(0, Q - 1).to(torch.int64))
    return run, accept, mark, pos, (torch.where(ok, head, 0) + pos) % qcap
