"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline.analysis``: the model-FLOPs rule for every arch, shape
and mode, the Roofline record and its table; the op-level cost model
(``op_cost``) on small calls whose counts are known; the unfused VR
traffic rows against the ops the port's VR step dispatches.
"""
import dataclasses

import pytest
import torch

from repro.config import INPUT_SHAPES as JSHAPES
from repro.config import get_arch as jget_arch
from repro.roofline import analysis as janalysis
from repro_torch.config import INPUT_SHAPES, get_arch, list_archs
from repro_torch.launch import mesh as meshlib
from repro_torch.optim import optimizers, vr_wrapper
from repro_torch.roofline import analysis, op_cost

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference_s(arch):
    for shape in INPUT_SHAPES:
        for mode in ("train", "prefill", "decode"):
            assert analysis.model_flops(get_arch(arch), INPUT_SHAPES[shape],
                                        mode) == janalysis.model_flops(
                jget_arch(arch), JSHAPES[shape], mode)


def test_roofline_record_and_table_are_the_reference_s():
    assert ([f.name for f in dataclasses.fields(analysis.Roofline)]
            == [f.name for f in dataclasses.fields(janalysis.Roofline)])
    vals = dict(arch="a", shape="s", mesh="pod", mode="train", chips=256,
                flops_per_device=1e12, bytes_per_device=2e9,
                collective_bytes_per_device=3e8, t_compute=1e-3,
                t_memory=2e-3, t_collective=3e-4, bottleneck="memory",
                model_flops_global=1e14, useful_fraction=0.4,
                peak_memory_bytes=3 * 2**30)
    rows = [analysis.Roofline(**vals),
            analysis.Roofline(**dict(vals, peak_memory_bytes=None))]
    jrows = [janalysis.Roofline(**r.to_dict()) for r in rows]
    assert analysis.format_table(rows) == janalysis.format_table(jrows)
    assert set(analysis.collective_bytes(op_cost.OpCost())) == set(
        janalysis.collective_bytes(""))


def test_h100_constants_and_terms():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    cost = op_cost.OpCost(flops=989e12, bytes_accessed=6.7e12,
                          collective_bytes=45e9)
    shape = INPUT_SHAPES["train_4k"]
    cfg = get_arch("qwen2-7b")
    r = analysis.analyze(cfg, shape, "train", "pod", 256, cost,
                         {"argument_size_in_bytes": 10,
                          "temp_size_in_bytes": 5})
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx(
        (1.0, 2.0, 0.1))
    assert r.bottleneck == "memory" and r.peak_memory_bytes == 15.0
    assert r.useful_fraction == pytest.approx(
        analysis.model_flops(cfg, shape, "train") / (989e12 * 256))


@pytest.mark.parametrize("mode", ["centralvr", "saga", "svrg"])
def test_unfused_vr_rows_count_the_ops_the_step_dispatches(mode):
    """The unfused VR step (``vr_wrapper.correct`` + SGD) moves the
    passes of ``VR_TRAFFIC`` mid-epoch and ``VR_EPOCH_TRAFFIC`` more at
    the epoch's end, as the op counter sees it (float32 state)."""
    n, M = 1000, 4
    got = {}
    for idx in (1, M - 1):
        p, g, gs = (torch.full((1, n), v) for v in (0.0, 1.0, 2.0))
        st = vr_wrapper.init_vr(mode, p, M)
        opt = optimizers.sgd(0.1)

        def step():
            v, _ = vr_wrapper.correct(mode, st, g, M, g_snap=gs, params=p,
                                      idx=idx)
            optimizers.apply_updates(p, opt.update(v, (), p)[0])
        got[idx] = op_cost.analyze_ops(step).bytes_accessed
    assert got[1] == analysis.vr_step_traffic(n, mode, fused=False)["bytes"]
    er, ew = analysis.VR_EPOCH_TRAFFIC[mode]
    assert got[M - 1] - got[1] == (er + ew) * n * 4
    amortised = analysis.vr_step_traffic(n, mode, fused=False, M=M)
    assert amortised["bytes"] == pytest.approx(
        got[1] + (got[M - 1] - got[1]) / M)


def test_vr_traffic_ratio_and_bf16_rows():
    assert analysis.vr_fused_traffic_ratio("centralvr") == 16 / 7
    f32 = analysis.vr_step_traffic(10, "centralvr", fused=True)
    bf16 = analysis.vr_step_traffic(10, "centralvr", fused=True,
                                    bytes_per_el=2)
    assert (f32["passes"], bf16["passes"]) == (7, 9)
    assert analysis.vr_step_traffic(10, "svrg", fused=True,
                                    bytes_per_el=2)["passes"] == 7


def test_op_cost_counts_a_matmul_and_leaves_views_out():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")

    def fn(a, b):
        c = a @ b                      # 64x16 out, 2*64*32*16 flops
        return c[1:].view(-1).t()      # views: no traffic

    cost = op_cost.analyze_ops(fn, a, b)
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.bytes_accessed == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert dict(cost.op_counts) == {"mm": 1}
    assert cost.temp_size_in_bytes == 64 * 16 * 4
    assert cost.result.shape == (63 * 16,)


def test_op_cost_peak_follows_the_live_storages():
    x = torch.empty(1000, device="meta")

    def fn(x):
        y = x * 2            # 4000 bytes live
        z = y + 1            # 8000
        del y                # back to 4000
        w = z * z            # 8000 again
        return w.sum()       # and the sum's 4 bytes beside z and w

    assert op_cost.analyze_ops(fn, x).temp_size_in_bytes == 8004


def test_op_cost_reads_the_stand_in_groups():
    from repro_torch.core import spmd
    m = meshlib.stand_in_mesh((2, 4), ("data", "model"), rank=5)
    t = torch.empty(3, 8, dtype=torch.bfloat16, device="meta")

    def fn(t):
        spmd.psum_(t, m.group("model"))
        spmd.all_gather(t, m.group("data"))
        return spmd.reduce_scatter_dim(t, m.group("model"), 1)

    cost = op_cost.analyze_ops(fn, t, mesh=m)
    assert dict(cost.collective_counts) == {
        "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
    assert dict(cost.collective_breakdown) == {
        "all-reduce": 48, "all-gather": 96, "reduce-scatter": 12}
    assert cost.collective_bytes == 156
    colls, top = op_cost.attribute(cost)
    assert colls[0] == (96, "all-gather", "bfloat16[2, 3, 8]", 1, "data")
    assert op_cost.from_metrics(op_cost.metrics(cost)).as_dict() == \
        cost.as_dict()
