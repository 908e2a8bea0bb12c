"""Trees of tensors to ``.npz`` plus a ``.json`` manifest — the port of
``repro/checkpoint/checkpoint.py``, in its format.

A tree is made of NamedTuples, dicts (keys in sorted order), lists and
tuples, with tensors and Python scalars as leaves; ``None`` is an empty
subtree. Each leaf is stored under its tree path, its keys
joined by ``/`` (a NamedTuple's field names, a dict's keys, a sequence's
indices), the reference's keys: a ``VRState``, ``SyncState`` or
``AsyncState`` one package saved restores in the other.

numpy has no bfloat16: a bfloat16 tensor is stored as its bits, a
``uint16`` array, and the manifest's ``dtypes`` names it ``bfloat16``;
restoring turns the bits back into bfloat16, so a bfloat16 state
round-trips bit for bit. An array that a bfloat16-capable numpy wrote
(the reference's, a two-byte void or ``bfloat16`` dtype) is read as the
same bits.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

BF16 = "bfloat16"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(key, child) pairs of a tree node, or None for a leaf."""
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` in the reference's key order."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, child in kids:
        out.update(flatten(child, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = [(k, _rebuild(child, fn, f"{prefix}/{k}" if prefix else str(k)))
           for k, child in kids]
    if _is_namedtuple(tree):
        return type(tree)(*(v for _, v in new))
    if isinstance(tree, dict):
        return {k: v for k, v in new}
    return type(tree)(v for _, v in new)


def _to_numpy(leaf) -> tuple:
    """(host array as stored, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str, tree, *, step: Optional[int] = None,
         extra: Optional[dict] = None) -> int:
    """Write ``tree`` to ``path`` (``.npz`` appended unless present, as
    numpy does) and its manifest to ``path + ".json"``: ``step``, ``keys``,
    ``shapes``, ``dtypes``, and the entries of ``extra``. Tensors are
    copied to the host first, so the caller may change them once this
    returns. Returns the bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(path, **arrays)
    manifest = {"step": step, "keys": sorted(arrays),
                "shapes": {k: list(v.shape) for k, v in arrays.items()},
                "dtypes": dtypes, **(extra or {})}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    npz = path if path.endswith(".npz") else path + ".npz"
    return os.path.getsize(npz) + os.path.getsize(path + ".json")


def _manifest_dtypes(path: str) -> dict:
    try:
        with open(path + ".json") as f:
            return json.load(f).get("dtypes", {})
    except FileNotFoundError:
        return {}


def load(path: str) -> dict:
    """``{path: host tensor}`` of every array in the checkpoint, bfloat16
    ones decoded from their bits."""
    dtypes = _manifest_dtypes(path)
    out = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for k in data.files:
            a = data[k]
            if dtypes.get(k) == BF16 or a.dtype.name == BF16:
                bits = np.ascontiguousarray(a).view(np.int16)
                out[k] = torch.from_numpy(bits).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(a)
    return out


def _leaf_from(saved: torch.Tensor, like, device):
    """A saved array in the type of ``like``: a tensor of its dtype on
    ``device`` (default ``like``'s), or a Python scalar."""
    if isinstance(like, torch.Tensor):
        return saved.to(device=like.device if device is None else device,
                        dtype=like.dtype)
    return type(like)(saved.item())


def _lookup(flat: dict, key: str):
    if key not in flat:
        raise KeyError(f"checkpoint missing {key!r}")
    return flat[key]


def restore(path: str, like, device=None):
    """A new tree of ``like``'s structure from the checkpoint at ``path``,
    each leaf in the type and dtype of ``like``'s (tensors on ``device``,
    default each ``like`` tensor's device)."""
    flat = load(path)
    return _rebuild(like, lambda k, leaf: _leaf_from(_lookup(flat, k), leaf,
                                                     device))


def restore_into(path: str, tree):
    """Restore in place: every tensor leaf of ``tree`` is overwritten with
    its saved values (``copy_``, so views of it stay valid); returns
    ``tree`` with its other leaves (Python scalars) replaced by the saved
    ones."""
    flat = load(path)

    def put(k, leaf):
        saved = _lookup(flat, k)
        if isinstance(leaf, torch.Tensor):
            if tuple(saved.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {k!r} has shape "
                                 f"{tuple(saved.shape)}, the state "
                                 f"{tuple(leaf.shape)}")
            return leaf.copy_(saved.to(leaf.dtype))
        return _leaf_from(saved, leaf, None)

    return _rebuild(tree, put)


def latest_step(path: str) -> Optional[int]:
    """The step the manifest at ``path`` records, or None if there is
    none."""
    try:
        with open(path + ".json") as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
