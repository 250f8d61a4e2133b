"""Every row's simulated ticks over the whole window's wall time, batch
restarts included (host clock, the window ending in a synchronize)."""


def read(run):
    return run.row_ticks / run.window_s if run.window_s else None
