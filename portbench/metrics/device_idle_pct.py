"""Share of the wall time per tick in which no device operation ran: the
traced sub-window's device busy time per tick (the union of the device
operations' intervals) against the wall time per tick of the window's
ticks before the profiler first ran.  The profiler slows the host's
launches for the rest of the process, so the traced sub-window's own wall
time would read that overhead as idle time."""


def read(run):
    p = run.prof
    if not p or not p["n_events"] or not p.get("unprofiled_s_per_tick"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["ticks"] / p["unprofiled_s_per_tick"])
