"""Entry points of the port (``serve``); the reference's mesh, roofline,
dry-run, cost, report and train launchers are not ported yet."""
