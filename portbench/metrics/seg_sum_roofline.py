"""The segment sums' share of the HBM roofline in the traced sub-window:
the bytes their calls need (``roofline.seg_sum_bytes``) over 3.35 TB/s,
over the device time of their kernels."""
from portbench.roofline import roofline_pct


def read(run):
    p = run.prof
    return roofline_pct(p["op_bytes"]["seg_sum"], p["op_time_s"]["seg_sum"]) if p else None
