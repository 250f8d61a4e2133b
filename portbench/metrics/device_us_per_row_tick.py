"""Device busy time (the union of the device operations' intervals) in the
traced sub-window, per row and tick, in microseconds."""


def read(run):
    p = run.prof
    return p["busy_s"] * 1e6 / (p["rows"] * p["ticks"]) if p and p["busy_s"] > 0 else None
