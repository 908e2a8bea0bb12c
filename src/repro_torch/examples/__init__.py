"""The reference's four examples on the port, each a module:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.convex_distributed [--backend spmd]
    python -m repro_torch.examples.serve_batched
    python -m repro_torch.examples.train_centralvr_100m [--full]

Each keeps the reference's flags and adds ``--device``: the runs go to
the CUDA device unless it names another (``--device cpu``). Each
``main(argv)`` returns what its printout reports, so a caller can check
the example's own claim.
"""
