"""Distribution over a mesh of cards (counterpart of ``repro.distrib``)."""
