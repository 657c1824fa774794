"""The repo's entry points on the port: counterparts of ``examples/``
(quickstart, serve_demo, comm_study, quant_demo, prefix_demo,
disagg_demo, chaos_demo).  Each runs on the card unless ``--device cpu``
is passed, and splits into ``run(cfg, params, device, ...)``, which does
the work and returns what the example prints and checks, and ``main``,
which builds the JAX example's config and weights from a seed, calls
``run`` and holds the example's invariants (``check``).
``examples/train_100m.py``'s counterpart is ``repro_torch.launch.train_100m``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
