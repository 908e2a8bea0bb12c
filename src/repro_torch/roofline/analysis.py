"""Roofline terms of a dry-run combo — the port of
``repro/roofline/analysis.py``, for one NVIDIA H100 SXM at its 700 W
power limit (NVIDIA's data sheet, dense rates):

    T_compute    = FLOPs_per_device / 989e12          (bf16 tensor cores)
    T_memory     = bytes_per_device / 3.35e12         (HBM3)
    T_collective = collective_bytes_per_device / 450e9 (NVLink, each way)

A card set below 700 W runs slower under load; these are the peaks at the
full limit. The link between hosts is not modelled: every collective is
charged at the NVLink rate, also on meshes larger than one host's eight
cards (the production meshes of 256 and 512 ranks), so T_collective is a
lower bound there.

The per-device FLOPs, bytes and collective bytes come from
``op_cost.analyze_ops``: the ops that one rank's call dispatches on meta
tensors (``launch/dryrun.py``), counted each time they run, so no loop is
undercounted. Its bytes are those of the eager program with every op its
own kernel; the fused kernels K1-K4 move less.

MODEL_FLOPS uses the 6·N·D rule (6·N_active·D for MoE) for training and
2·N·D for prefill and single-token decode; the ratio MODEL_FLOPS /
(FLOPs_per_device * chips) measures useful compute (remat recompute,
attention's quadratic work and work replicated over 'model' all push it
down).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

# NVIDIA H100 SXM, 700 W power limit (data sheet, dense)
PEAK_FLOPS = 989e12        # bf16 FLOP/s / card
HBM_BW = 3.35e12           # bytes/s / card
LINK_BW = 450e9            # bytes/s / card, NVLink each way

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ---------------------------------------------------------------------------
# VR-step memory traffic (param-sized passes per inner-loop step)
# ---------------------------------------------------------------------------
# float32 state, W workers' flat (W, N) buffers (train/step.py); a pass is
# one read or one write of a param-sized buffer.
#
# Fused (optim/vr_wrapper.py:apply, one K1 launch):
#   centralvr  K1 reads x, g, the table row, gbar, gtilde and writes x',
#              gtilde'; the row then takes g by rebinding (no copy)
#                                                              -> 5r / 2w
#   saga       the same five reads; K1 writes x', gtilde' and gbar'; then
#              gtilde.zero_() drops the accumulator lane (one more write)
#                                                              -> 5r / 4w
#   svrg       K1 reads x, g, g_snap, gbar, gtilde; writes x', gtilde'
#                                                              -> 5r / 2w
# Unfused (vr_wrapper.correct + optimizers.sgd + apply_updates, one eager
# op a pass, each op reading its operands and writing its result):
#   centralvr  gs - old (2r/1w), + gbar (2r/1w), gs / M (1r/1w),
#              gtilde.add_ (2r/1w), -lr * v (1r/1w), params.add_ (2r/1w)
#                                                              -> 10r / 6w
#   saga       v as centralvr (4r/2w), gs - old, / M, gbar.add_ (5r/3w),
#              the update (3r/2w)                              -> 12r / 7w
#   svrg       gs - g_snap, + gbar (4r/2w), gs / M, gtilde.add_ (3r/2w),
#              the update (3r/2w)                              -> 10r / 6w
VR_TRAFFIC = {
    ("centralvr", True): (5, 2), ("centralvr", False): (10, 6),
    ("saga", True): (5, 4), ("saga", False): (12, 7),
    ("svrg", True): (5, 2), ("svrg", False): (10, 6),
}
# once every M steps, fused or not: the epoch end's gtilde.zero_()
# (vr_wrapper._roll: centralvr, svrg), and SVRG's snapshot copy of the
# params (1r/1w)
VR_EPOCH_TRAFFIC = {"centralvr": (0, 1), "saga": (0, 0), "svrg": (1, 2)}
# bfloat16 state: _write_row's rounding copy of g into the table row
# (centralvr, saga; 1r/1w), and unfused, the cast gs = g.to(bf16) (1r/1w)
VR_BF16_ROW = (1, 1)
VR_BF16_CAST = (1, 1)


def vr_step_traffic(n_params: int, mode: str, *, fused: bool,
                    bytes_per_el: int = 4, M: Optional[int] = None) -> dict:
    """Predicted traffic of one VR inner-loop step over ``n_params``
    parameters: the param-sized passes of the tables above, with the
    bfloat16 rows (``bytes_per_el`` 2) and, when ``M`` is given, the
    epoch-end passes amortised over the M steps."""
    reads, writes = VR_TRAFFIC[(mode, bool(fused))]
    if bytes_per_el == 2:
        if mode != "svrg":
            reads, writes = reads + VR_BF16_ROW[0], writes + VR_BF16_ROW[1]
        if not fused:
            reads, writes = reads + VR_BF16_CAST[0], writes + VR_BF16_CAST[1]
    if M:
        er, ew = VR_EPOCH_TRAFFIC[mode]
        reads, writes = reads + er / M, writes + ew / M
    return {"mode": mode, "fused": bool(fused), "reads": reads,
            "writes": writes, "passes": reads + writes,
            "bytes": float((reads + writes) * n_params * bytes_per_el)}


def vr_fused_traffic_ratio(mode: str) -> float:
    """Unfused/fused traffic ratio of one float32 VR step (epoch-end
    passes left out) — 16/7 for centralvr."""
    ru, wu = VR_TRAFFIC[(mode, False)]
    rf, wf = VR_TRAFFIC[(mode, True)]
    return (ru + wu) / (rf + wf)


def collective_bytes(cost) -> dict:
    """Per-collective-kind result bytes and counts (``n_<kind>``) of an
    ``op_cost.OpCost``, the reference's layout."""
    out = {k: float(cost.collective_breakdown.get(k, 0.0))
           for k in COLLECTIVE_KINDS}
    out.update({f"n_{k}": float(cost.collective_counts.get(k, 0.0))
                for k in COLLECTIVE_KINDS})
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    mode: str                   # train / prefill / decode
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_global: float
    useful_fraction: float      # MODEL_FLOPS / (FLOPs_per_device * chips)
    peak_memory_bytes: Optional[float] = None
    collectives: Optional[dict] = None

    def to_dict(self):
        return asdict(self)


def model_flops(cfg, shape, mode: str) -> float:
    """6·N·D training / 2·N·D forward rule (N active params, D tokens)."""
    n_active = cfg.active_param_count()
    if mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1          # decode: one token per seq
    return 2.0 * n_active * tokens


def analyze(cfg, shape, mode: str, mesh_name: str, chips: int, cost,
            memory: Optional[dict] = None) -> Roofline:
    """The three terms of one rank's call from its ``op_cost.OpCost``
    (the reference takes the compiled HLO text here, and the number of
    gradients a step takes, which the op count already holds);
    ``memory`` is the dry run's record (``argument_size_in_bytes`` +
    ``temp_size_in_bytes`` give the peak)."""
    flops = cost.flops
    byts = cost.bytes_accessed
    cbytes = cost.collective_bytes
    t_c = flops / PEAK_FLOPS
    t_m = byts / HBM_BW
    t_x = cbytes / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, mode)
    useful = mf / max(flops * chips, 1.0)
    peak = None
    if memory and memory.get("temp_size_in_bytes") is not None:
        peak = float(memory["temp_size_in_bytes"]
                     + memory.get("argument_size_in_bytes", 0))
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, mode=mode,
        chips=chips, flops_per_device=flops, bytes_per_device=byts,
        collective_bytes_per_device=cbytes, t_compute=t_c, t_memory=t_m,
        t_collective=t_x, bottleneck=bottleneck, model_flops_global=mf,
        useful_fraction=useful, peak_memory_bytes=peak,
        collectives=collective_bytes(cost))


def format_table(rows) -> str:
    """Markdown table, the reference's columns."""
    hdr = ("| arch | shape | mesh | mode | T_comp (ms) | T_mem (ms) | "
           "T_coll (ms) | bottleneck | useful | peak GiB/dev |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        peak = (f"{r.peak_memory_bytes / 2**30:.2f}"
                if r.peak_memory_bytes else "-")
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.mode} "
            f"| {r.t_compute * 1e3:.2f} | {r.t_memory * 1e3:.2f} "
            f"| {r.t_collective * 1e3:.3f} | {r.bottleneck} "
            f"| {r.useful_fraction:.2f} | {peak} |")
    return "\n".join(lines)
