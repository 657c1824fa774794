"""The paper's tables and figures on the port: counterparts of the JAX
package's ``benchmarks/`` scripts that compute them (Tables III–VI, Figs
4 and 6–10, the planner) and of its dry-run readers.  Each module has
``rows() -> [(name, us_per_call, derived)]`` and ``main()``; ``run``
prints every row as one CSV.

    PYTHONPATH=src python -m repro_torch.paper.run
"""
