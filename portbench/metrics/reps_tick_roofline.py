"""The fused REPS update's share of the HBM roofline in the traced
sub-window (``roofline.reps_tick_bytes`` over 3.35 TB/s, over its kernels'
device time)."""
from portbench.roofline import roofline_pct


def read(run):
    p = run.prof
    return roofline_pct(p["op_bytes"]["reps_tick"], p["op_time_s"]["reps_tick"]) if p else None
