"""Entry points of the port: ``serve``, ``train``, and the mesh, roofline,
dry-run, cost and report launchers."""
