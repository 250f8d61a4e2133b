"""The first batch's ``bucket_carry`` (``Simulator.init_state`` row by row,
stacked), host clock ending in a synchronize."""


def read(run):
    return run.init_rows_s
