"""Op-level cost model of one call on meta tensors — the port's
counterpart of the reference's ``roofline/hlo_cost.py``.

The port has no compiled module to parse: its program is the sequence of
aten ops that one rank's call dispatches. :func:`analyze_ops` runs the
call once, on meta tensors (``launch/dryrun.py`` builds them over a
stand-in mesh, ``launch.mesh.stand_in_mesh``), and counts every op each
time it runs, so loops over layers and microbatches are weighted by
their trip counts by construction:

  * ``flops``: the counts of ``torch.utils.flop_counter``'s registry
    (matmuls, batched matmuls, convolutions, attention), forward and
    backward, taken op by op as ``FlopCounterMode`` takes them;
  * ``bytes_accessed``: each aten op's input and output tensor bytes,
    every op its own kernel, with views, allocations and metadata ops
    left out (and the destination of ``zero_``, ``fill_`` and ``copy_``
    counted as written, not read). This is the traffic of the eager program; the fused
    kernels K1-K4 on the card move less, and an op whose operands stay
    in cache moves less too;
  * the collective fields: the entries that ``core/spmd.py``'s
    collectives append to the stand-in groups' logs during the call
    (result-shape bytes, the reference's convention). Collectives are
    not in ``bytes_accessed``;
  * ``temp_size_in_bytes``: the largest total of the storages that the
    call's ops allocated and that were alive at once (autograd's saved
    tensors included), tracked by ``weakref.finalize`` on each new
    storage.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# allocations and metadata: no bytes move
_NO_TRAFFIC = {
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.lift_fresh.default, aten.sym_size.int, aten.sym_stride.int,
    aten.sym_numel.default, aten.sym_storage_offset.default,
    aten.is_same_size.default, aten.resize_.default,
}


@dataclass
class OpCost:
    """The reference's ``HloCost`` fields, and the call's memory."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    temp_size_in_bytes: int = 0
    op_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    op_counts: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    # (kind, "dtype[shape]", axes of the group) -> [bytes, count]
    collective_rows: Dict[tuple, list] = field(default_factory=dict)
    result: Any = None              # what the call returned

    def as_dict(self):
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collectives": dict(self.collective_breakdown),
            "collective_counts": dict(self.collective_counts),
        }


# in-place ops that write their first argument without reading it
_WRITE_ONLY = {aten.zero_.default, aten.fill_.Scalar, aten.fill_.Tensor,
               aten.copy_.default}


def _is_view(func) -> bool:
    """An op whose result aliases an input without writing it (a view,
    ``split``, ``expand``...); in-place ops (a written alias) are not."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _fresh(func) -> bool:
    """An op whose results are new storages (no alias annotation)."""
    return all(r.alias_info is None for r in func._schema.returns)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Counts each op's FLOPs and tensor bytes into ``cost`` and tracks
    the live bytes of the storages the ops allocate."""

    def __init__(self, cost: OpCost):
        from torch.utils.flop_counter import flop_registry
        super().__init__()
        self.flop_registry = flop_registry
        self.cost = cost
        self.live = 0
        self.seen: Dict[int, int] = {}

    def _release(self, key: int) -> None:
        self.live -= self.seen.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.seen:
            return
        n = st.nbytes()
        self.seen[key] = n
        self.live += n
        weakref.finalize(st, self._release, key)
        if self.live > self.cost.temp_size_in_bytes:
            self.cost.temp_size_in_bytes = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.flop_registry.get(func.overloadpacket)
        if count is not None:
            self.cost.flops += count(*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func not in _NO_TRAFFIC and not _is_view(func):
            ins = [t for t in tree_flatten(
                (args[1:] if func in _WRITE_ONLY else args, kwargs))[0]
                if isinstance(t, torch.Tensor)]
            n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            name = str(func.overloadpacket.__name__)
            self.cost.bytes_accessed += n
            self.cost.op_bytes[name] += n
            self.cost.op_counts[name] += 1
        if _fresh(func):
            for t in outs:
                self._track(t)
        return out


def analyze_ops(fn, *args, mesh=None, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once and count what it dispatches
    (module docstring). ``mesh``: the stand-in mesh whose groups' logs
    give the collective fields. The result of ``fn`` is in
    ``cost.result``."""
    cost = OpCost()
    groups = {}
    for key, g in (mesh.groups.items() if mesh is not None else ()):
        if all(g is not h for h in groups.values()):
            groups[key] = g
    marks = {k: len(g.log) for k, g in groups.items()}
    with _Traffic(cost):
        cost.result = fn(*args, **kwargs)
    cost.flops = float(cost.flops)
    for key, g in groups.items():
        for kind, shape, dtype, nbytes in g.log[marks[key]:]:
            cost.collective_bytes += nbytes
            cost.collective_breakdown[kind] += nbytes
            cost.collective_counts[kind] += 1
            row = cost.collective_rows.setdefault(
                (kind, f"{str(dtype).replace('torch.', '')}{list(shape)}",
                 "/".join(key) or "-"), [0, 0])
            row[0] += nbytes
            row[1] += 1
    return cost


def metrics(cost: OpCost, shapes: bool = True) -> Dict[tuple, float]:
    """The counts of ``cost`` as one flat map (keys are tuples), the form
    that :func:`from_metrics` reads back. ``shapes=False`` merges the
    collective rows of one kind, dtype and group whatever their shapes
    (``dtype[*]``)."""
    m = {("flops",): cost.flops, ("bytes_accessed",): cost.bytes_accessed,
         ("collective_bytes",): cost.collective_bytes}
    for kind, v in cost.collective_breakdown.items():
        m[("collectives", kind)] = v
    for kind, v in cost.collective_counts.items():
        m[("collective_counts", kind)] = v
    for (kind, shape, axes), (b, n) in cost.collective_rows.items():
        if not shapes:
            shape = shape.split("[")[0] + "[*]"
        for name, v in (("row_bytes", b), ("row_count", n)):
            key = (name, kind, shape, axes)
            m[key] = m.get(key, 0) + v
    for op, b in cost.op_bytes.items():
        m[("op_bytes", op)] = b
    for op, n in cost.op_counts.items():
        m[("op_counts", op)] = n
    return m


def from_metrics(m: Dict[tuple, float]) -> OpCost:
    """The :class:`OpCost` of a flat map of :func:`metrics`' form."""
    cost = OpCost(flops=m.get(("flops",), 0.0),
                  bytes_accessed=m.get(("bytes_accessed",), 0.0),
                  collective_bytes=m.get(("collective_bytes",), 0.0))
    for key, v in m.items():
        if key[0] == "collectives":
            cost.collective_breakdown[key[1]] = v
        elif key[0] == "collective_counts":
            cost.collective_counts[key[1]] = v
        elif key[0] in ("row_bytes", "row_count"):
            row = cost.collective_rows.setdefault(key[1:], [0, 0])
            row[key[0] == "row_count"] = v
        elif key[0] == "op_bytes":
            cost.op_bytes[key[1]] = v
        elif key[0] == "op_counts":
            cost.op_counts[key[1]] = v
    return cost


def attribute(cost: OpCost, top: int = 15):
    """The perf-debugging view, as the reference's: the top collectives
    as ``(total bytes, kind, shape, count, axes)`` rows, grouped by kind,
    result shape, dtype and group, and the top byte contributors as
    ``(aten op, bytes)``."""
    colls = sorted(((total, kind, shape, count, axes)
                    for (kind, shape, axes), (total, count)
                    in cost.collective_rows.items()), reverse=True)
    byte_top = sorted(cost.op_bytes.items(), key=lambda kv: -kv[1])[:top]
    return colls[:top], byte_top
