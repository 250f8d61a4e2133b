"""The port's figure grids (counterpart of the reference's ``benchmarks/``
grid figures fig02-fig08): each figure's cell list (``cases``) run as one
sweep (``common.figure_grid`` -> ``repro_torch.netsim.sweep``), and
``python -m repro_torch.bench.run`` writing the rows to a BENCH file of its
own under ``build/repro_torch/``."""
