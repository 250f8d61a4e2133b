"""The kernels' entry points of the frozen formulation: every call goes to
its plain version in ``ref``, on whatever device its tensors are."""
from __future__ import annotations

from . import ref
from .kshapes import TILE


def seg_sum(seg, vals, n_segments: int):
    return ref.seg_sum_ref(seg, vals, n_segments)


def seg_rank(seg, n_segments: int):
    return ref.seg_rank_ref(seg, n_segments)


def reps_tick(*args, trace_rows=None):
    return ref.reps_tick_ref(*args, trace_rows=trace_rows)


def queue_tick(target, u, qlen, serve, capacity, kmin, kmax, red_rcp=None, pmax=1.0,
               q_head=None, qcap=None):
    return ref.queue_tick_ref(target, u, qlen, serve, capacity, kmin, kmax, red_rcp, pmax,
                              q_head, qcap, tile=TILE)


def ecmp_hash(flow, ev, salt, nports):
    return ref.ecmp_hash_ref(flow, ev, salt, nports)


def next_queue(g, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive: bool,
               q_penalty=None, a_idx=None, n_pkt: int = 0):
    return ref.next_queue_ref(g, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                              adaptive, q_penalty, a_idx, n_pkt)


def next_queue_table(t, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive: bool,
                     q_penalty=None, a_idx=None, n_pkt: int = 0):
    return ref.next_queue_table_ref(t, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                                    adaptive, q_penalty, a_idx, n_pkt)
