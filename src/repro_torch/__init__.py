"""PyTorch / CUDA port of the REPS packet simulator (the JAX package
``repro`` is the reference it is held against).  Same sub-package layout:
``core`` (REPS and the load balancers), ``netsim`` (the simulator),
``kernels`` (the hand-written Hopper kernels and their plain versions),
``configs`` (the paper's presets), plus ``rng`` (bit-exact ``jax.random``)."""
