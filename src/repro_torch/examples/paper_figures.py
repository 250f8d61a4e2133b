"""Reproduce a subset of the paper's figures quickly: the figure 1, 3 and 6
micro runs (the port of the reference's ``examples/paper_figures.py``).

    PYTHONPATH=src python -m repro_torch.examples.paper_figures [--device cpu]

Every figure: ``python -m repro_torch.bench.run``.
"""
from __future__ import annotations

from repro_torch.bench import fig01_tornado_micro, fig03_asym_micro, fig06_failures_micro
from repro_torch.bench.common import Rows
from repro_torch.device import resolve_device
from repro_torch.examples import parse_device


def main(device=None) -> Rows:
    """Prints the rows as CSV and returns them."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.library()  # the kernels are built before any run is timed
    rows = Rows(device=dev.type)
    print("name,us_per_call,derived")
    for fig in (fig01_tornado_micro, fig03_asym_micro, fig06_failures_micro):
        fig.main(rows, device=dev)
    return rows


def cli(argv=None):
    return main(parse_device(__doc__, argv))


if __name__ == "__main__":
    cli()
