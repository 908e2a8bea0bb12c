"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The solver API is re-exported lazily, as in ``repro``:

    import repro_torch
    from repro_torch.configs.paper_convex import PRESETS
    res = repro_torch.solve(repro_torch.RunSpec("centralvr_sync", p=8),
                            PRESETS["dist-toy-logistic"])

Runs go to the CUDA device unless the caller passes ``device="cpu"``.
This package imports torch and numpy only: never jax, never ``repro``.
"""
__version__ = "0.1.0"

_SOLVER_EXPORTS = ("solve", "RunSpec", "RunResult", "AlgoCaps",
                   "REGISTRY", "algorithms", "runner")

__all__ = list(_SOLVER_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _SOLVER_EXPORTS:
        from repro_torch.core import solver
        return getattr(solver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
