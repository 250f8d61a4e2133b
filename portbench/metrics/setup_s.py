"""Process start to the first timed tick: imports, the kernel library,
inputs, the engine, ``bucket_carry`` and the warm-up chunks."""


def read(run):
    return run.setup_s
