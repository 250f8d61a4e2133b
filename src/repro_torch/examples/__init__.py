"""The user examples (the reference's ``examples/``), one module each, run
as ``python -m repro_torch.examples.<name> [--device cpu]``: ``quickstart``
(ECMP, OPS and REPS healthy and under two uplink failures), ``failover_demo``
(a spine killed mid-run through the soak runtime), ``paper_figures``
(figures 1, 3 and 6), ``serve_batched`` (the serving launcher) and
``train_lm`` (the training launcher, with checkpoints).  Each runs on the
card unless it is given ``--device cpu``; each ``main(device=None, ...)``
takes the reference script's constants as keyword arguments.
``time_all`` times the five at full length, one process each."""
from __future__ import annotations

import argparse


def parse_device(doc: str, argv=None, passthrough: bool = False):
    """The examples' command line: ``--device`` alone, or with the rest of
    the arguments handed on (``passthrough``).  Returns the device (None:
    the card), and with ``passthrough`` also the rest."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    if passthrough:
        args, rest = ap.parse_known_args(argv)
        return args.device, rest
    return ap.parse_args(argv).device
