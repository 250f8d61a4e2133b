"""The traced sub-window: what ``torch.profiler`` saw on the device, reduced
to counts, busy time, idle gaps and per-operation time.

The arithmetic follows ``tools/tick_ops.py`` (every device event the
profiler records is one launch; its time is its elapsed time).  The
profiler is known to drop events now and then, so ``launch_mismatch``
holds its counts of the engine's hand-written kernels against the exact
counters of ``repro_torch.kernels.ops``; the harness shortens the
sub-window until they agree.
"""
from __future__ import annotations

import collections

# the engine's hand-written kernels: the ops entry point -> the device
# kernels one call launches (by the name's start); zero_i32 is the
# zeroing pass of seg_sum's global path, not a launch of its own entry
KERNELS = {
    "seg_sum": ("seg_sum_shared", "seg_sum_global"),
    "seg_rank": ("seg_rank_table", "seg_rank_turns"),
    "reps_tick": ("reps_tick_kernel",),
    "queue_tick": ("queue_tick_kernel",),
    "next_queue": ("next_queue_kernel",),
}
# every device kernel of an operation, for its device time
OP_KERNELS = {"seg_sum": ("seg_sum_shared", "seg_sum_global", "zero_i32"),
              "reps_tick": ("reps_tick_kernel",)}


def _base(name: str) -> str:
    """A kernel's name without its namespace, return type, template and
    arguments (the port's kernels sit in anonymous namespaces)."""
    n = name.replace("(anonymous namespace)::", "")
    n = n.split("(")[0].split("<")[0].strip()
    return n.split(" ")[-1].split("::")[-1]


def device_events(prof) -> list[tuple[str, float, float]]:
    """``(name, start us, end us)`` of every device event, in start order."""
    import torch

    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    out.sort(key=lambda x: x[1])
    return out


def reduce(events, host_window_s: float) -> dict:
    """Counts by name, the busy time (union of the events' intervals), the
    idle gaps (each named by the device operation that ended it) and each
    operation's device time."""
    by_name = collections.defaultdict(lambda: [0, 0.0])
    busy_us, cur_s, cur_e = 0.0, None, None
    gaps = []
    for name, s, e in events:
        by_name[name][0] += 1
        by_name[name][1] += e - s
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((f"before {_base(name)}", (s - cur_e) * 1e-6))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    kernel_counts = {op: sum(n for name, (n, _) in by_name.items() if _base(name).startswith(ks))
                     for op, ks in KERNELS.items()}
    op_time_s = {op: sum(us for name, (_, us) in by_name.items()
                         if _base(name).startswith(ks)) * 1e-6
                 for op, ks in OP_KERNELS.items()}
    by_base = collections.Counter()
    for name, (n, _) in by_name.items():
        by_base[_base(name) or name[:60]] += n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    gaps.sort(key=lambda g: -g[1])
    return dict(
        n_events=len(events), busy_s=busy_us * 1e-6, window_s=host_window_s,
        kernel_counts=kernel_counts, op_time_s=op_time_s, launches_by_name=dict(by_base),
        device_ops=[[name[:120], us * 1e-6] for name, (_, us) in top],
        idle_gaps=[[n, s] for n, s in gaps[:10]],
    )


def launch_mismatch(reduced: dict, counter_delta: dict) -> dict:
    """``{op: (profiler count, exact count)}`` where the two disagree."""
    return {op: (reduced["kernel_counts"][op], counter_delta.get(op, 0))
            for op in KERNELS if reduced["kernel_counts"][op] != counter_delta.get(op, 0)}
