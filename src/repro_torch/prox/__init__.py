"""repro_torch.prox — composite objectives: proximal operators and the
sparse lazy-correction driver.

Lazy re-exports, as in ``repro.prox`` (``import repro_torch.prox`` loads
nothing until a name is used):

  * ``ProxSpec`` / ``parse`` / ``apply`` / ``penalty`` — operator library
  * ``run_sparse`` — lazy CentralVR on fixed-width sparse rows
"""
from __future__ import annotations

_LAZY = {
    "ProxSpec": ("repro_torch.prox.operators", "ProxSpec"),
    "parse": ("repro_torch.prox.operators", "parse"),
    "apply": ("repro_torch.prox.operators", "apply"),
    "apply_prox": ("repro_torch.prox.operators", "apply_prox"),
    "penalty": ("repro_torch.prox.operators", "penalty"),
    "names": ("repro_torch.prox.operators", "names"),
    "is_elementwise": ("repro_torch.prox.operators", "is_elementwise"),
    "numeric_prox": ("repro_torch.prox.operators", "numeric_prox"),
    "run_sparse": ("repro_torch.prox.lazy", "run_sparse"),
    "sparsify": ("repro_torch.prox.lazy", "sparsify"),
    "make_sparse_data": ("repro_torch.prox.lazy", "make_sparse_data"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value
