"""Entry points of the port (``serve``, ``train``); the reference's mesh, roofline,
dry-run, cost and report launchers are not ported yet."""
