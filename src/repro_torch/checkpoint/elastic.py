"""Mesh-shape-portable checkpoints of the elastic asynchronous runtime —
the port of ``repro/checkpoint/elastic.py``, in its format.

A checkpoint taken at a wave boundary holds the full per-worker
``AsyncState`` at the shape it was saved at, so restoring at the same
worker count is exact. Its central pair ``(x_c, gbar_c)`` and the merged
``(n,)`` VR table are the shape-portable core: restoring at another
worker count re-shards the table contiguously and resyncs every
per-worker fetch/old vector to the central values
(``core.elastic.resync_state``), the handover a live repartition makes.

The format is ``checkpoint.py``'s: one ``.npz`` of host arrays (the
state's field names as keys) and a ``.json`` manifest (``kind``,
``round``, ``p``, ``ns``, ``n``, ``d``, the live worker ids, ``p0`` and
``dtypes``), so either package reads the other's.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _norm(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_elastic(path: str, st, *, round_: int, live: Sequence[int],
                 p0: int) -> None:
    """Persist an ``AsyncState`` at a wave boundary. ``live`` are the
    ORIGINAL worker ids of the current shape; ``p0`` the fleet size the
    run started with."""
    path = _norm(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}
    np.savez(path, **arrays)
    p, ns = arrays["tables"].shape
    manifest = {
        "kind": "elastic_async", "round": int(round_), "p": int(p),
        "ns": int(ns), "n": int(p * ns), "d": int(arrays["x_c"].shape[0]),
        "live": [int(s) for s in live], "p0": int(p0),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_manifest(path: str) -> dict:
    with open(_norm(path) + ".json") as f:
        return json.load(f)


def restore_elastic(path: str, p_new: Optional[int] = None, *,
                    device=None) -> Tuple:
    """Rebuild an ``AsyncState`` on ``device`` (None: the current CUDA
    device) from a wave-boundary checkpoint: ``p_new`` None (or the saved
    shape) restores the per-worker state exactly; any other shape goes
    through the merged-table resync handover. Returns ``(state,
    manifest)``."""
    from repro_torch.core.distributed import AsyncState
    from repro_torch.core.elastic import resync_state
    from repro_torch.kernels import resolve_device

    device = resolve_device(device, "restore_elastic")
    path = _norm(path)
    manifest = load_manifest(path)
    with np.load(path) as data:
        arrays = {k: torch.from_numpy(np.array(data[k])).to(device)
                  for k in AsyncState._fields}
    if p_new is None or p_new == manifest["p"]:
        return AsyncState(**arrays), manifest
    if manifest["n"] % p_new:
        raise ValueError(
            f"restore_elastic: checkpoint has n={manifest['n']} samples, "
            f"which does not divide over p={p_new} workers")
    st = resync_state(arrays["x_c"], arrays["gbar_c"],
                      arrays["tables"].reshape(-1), p_new)
    return st, manifest


def latest_elastic(dirpath: str) -> Optional[str]:
    """Path (without extension) of the highest-round elastic checkpoint
    in ``dirpath``, or None."""
    best, best_round = None, -1
    try:
        names = os.listdir(dirpath)
    except FileNotFoundError:
        return None
    for name in names:
        if not (name.startswith("elastic_") and name.endswith(".npz.json")):
            continue
        stem = os.path.join(dirpath, name[:-len(".npz.json")])
        try:
            r = load_manifest(stem)["round"]
        except (OSError, KeyError, json.JSONDecodeError):
            continue
        if r > best_round:
            best, best_round = stem, r
    return best
