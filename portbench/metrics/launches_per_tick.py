"""Device operations the profiler recorded in the traced sub-window, per
tick (kernels, copies and fills, as ``tools/tick_ops.py`` counts them)."""


def read(run):
    p = run.prof
    return p["n_events"] / p["ticks"] if p and p["n_events"] else None
