"""The port's dry run (``repro_torch.launch.dryrun``) and the pieces it
stands on: the solver registry's ``algorithms()`` / ``runner()`` and
``obs.comms.coverage_gaps`` against the reference's; the stand-in mesh
(``launch.mesh.stand_in_mesh``) and its recording collectives; the three
lanes that ``chip_smoke.py`` measured on the card (8b, 8d, 7b), whose
collectives, bytes and params a step a rank the stand-in must count
exactly; meta FLOPs against a real CPU step; the extrapolation from
probes against a whole trace; a production combo; the command line.
"""
import dataclasses
import importlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro
import repro_torch
from repro_torch.config import INPUT_SHAPES, TrainConfig, get_arch
from repro_torch.core import spmd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import solve as solve_cli
from repro_torch.obs import comms
from repro_torch.roofline import analysis, op_cost
from repro_torch.train import step as tstep

torch.set_num_threads(1)

# chip_smoke.py's lanes as the card counted them (NVIDIA H100 80GB HBM3,
# 700.00 W): collectives and bytes a step a rank, params a rank
LANES = {"8b": (140, 5_842_792_428, 390_880_256),
         "8d": (164, 8_361_021_420, 468_331_008),
         "7b": (58, 8_192_000, 3_859_304_960)}


# ---------------------------------------------------------------------------
# The solver registry and the comms models
# ---------------------------------------------------------------------------

def test_algorithms_are_the_reference_s_in_its_order():
    assert repro_torch.algorithms() == repro.algorithms()
    assert len(repro_torch.algorithms()) == 11


def test_runner_resolves_each_name_to_its_driver():
    drivers = [repro_torch.runner(n) for n in repro_torch.algorithms()]
    assert len(set(drivers)) == 11
    for name, fn in zip(repro_torch.algorithms(), drivers):
        e = repro_torch.REGISTRY[name]
        jm = repro.REGISTRY[name]
        assert (e.module.replace("repro_torch.", "repro."), e.func) == (
            jm.module, jm.func)
        assert fn is getattr(importlib.import_module(e.module), e.func)
        assert fn.__module__ == e.module


def test_coverage_gaps_match_the_reference_s():
    from repro.obs import comms as jcomms
    assert comms.coverage_gaps(repro_torch.algorithms()) == ((), ())
    bogus = repro_torch.algorithms() + ("made_up",)
    assert comms.coverage_gaps(bogus) == jcomms.coverage_gaps(bogus) == (
        ("made_up",), ())
    assert comms.coverage_gaps(repro_torch.algorithms()[1:]) == (
        (), ("centralvr",))


def test_the_solver_cli_lists_in_registration_order(capsys):
    solve_cli.print_list()
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert tuple(names) == repro.algorithms()


# ---------------------------------------------------------------------------
# The stand-in mesh
# ---------------------------------------------------------------------------

def test_stand_in_mesh_has_the_production_groups():
    m = meshlib.stand_in_mesh((2, 16, 16), ("pod", "data", "model"),
                              rank=300)
    assert (m.world, m.coords, m.device.type, m.transport) == (
        512, (1, 2, 12), "meta", "record")
    sizes = {k: (g.world, g.rank) for k, g in m.groups.items()}
    assert sizes == {(): (1, 0), ("pod", "data", "model"): (512, 300),
                     ("pod",): (2, 1), ("data",): (16, 2),
                     ("model",): (16, 12), ("pod", "data"): (32, 18)}
    assert dryrun.production_mesh("pod").shape == (16, 16)
    with pytest.raises(ValueError, match="rank 256"):
        meshlib.stand_in_mesh((16, 16), ("data", "model"), rank=256)


def test_record_collectives_return_the_real_shapes_and_log():
    m = meshlib.stand_in_mesh((4, 2), ("data", "model"), rank=3)
    g = m.group("data")
    t = torch.empty(6, 5, dtype=torch.bfloat16, device="meta")
    assert spmd.psum_(t, g) is t
    assert spmd.pmax_(t, g) is t
    assert spmd.all_gather(t, g).shape == (4, 6, 5)
    assert spmd.all_gather_dim(t, g, 1).shape == (6, 20)
    assert spmd.reduce_scatter_dim(t, g, 0).shape == (2, 5)
    assert [e[0] for e in g.log] == ["all-reduce", "all-reduce",
                                     "all-gather", "all-gather",
                                     "reduce-scatter"]
    assert g.log[2] == ("all-gather", (4, 6, 5), torch.bfloat16, 240)
    assert (g.collectives, g.carried_bytes) == (5, 60 + 60 + 240 + 240 + 20)
    # a group of one: no collective, as on real ranks
    assert spmd.pmax_(t, m.group(())) is t and not m.group(()).log


def test_record_group_refuses_real_tensors():
    g = meshlib.stand_in_mesh((2, 2), ("data", "model")).group("model")
    for fn in (spmd.psum_, spmd.pmax_, spmd.all_gather):
        with pytest.raises(RuntimeError, match="meta"):
            fn(torch.ones(3), g)
    with pytest.raises(RuntimeError, match="meta"):
        spmd.reduce_scatter_dim(torch.ones(4), g, 0)
    assert g.collectives == 0


# ---------------------------------------------------------------------------
# The card's lanes, counted on meta
# ---------------------------------------------------------------------------

def _lane_tcfg():
    """Lanes 8b and 8d: seq 1024, W 1, 2 microbatches of 2 rows, M 2."""
    return TrainConfig(seq_len=1024, global_batch=4, microbatch=2,
                       learning_rate=1e-2, optimizer="sgd", vr="centralvr",
                       vr_table_size=2, local_epoch=1, remat="block", seed=0)


@pytest.mark.parametrize("lane,arch", [("8b", "qwen2-7b"),
                                       ("8d", "qwen3-moe-30b-a3b")])
def test_stand_in_counts_the_mesh_lanes(lane, arch):
    cfg = dataclasses.replace(get_arch(arch), num_layers=2)
    for rank in (0, 3):
        m = meshlib.stand_in_mesh((2, 2), ("data", "model"), rank=rank)
        run = dryrun.dry_train(cfg, _lane_tcfg(), m)
        cost = run["cost"]
        assert "extrapolated" not in run
        assert (sum(cost.collective_counts.values()), cost.collective_bytes,
                run["local_params"]) == LANES[lane]
        assert (m.collectives, m.carried_bytes) == LANES[lane][:2]


def test_stand_in_counts_the_tp_decode_lane():
    m = meshlib.stand_in_mesh((1, 2), ("data", "model"), rank=1)
    run = dryrun.dry_decode(get_arch("qwen2-7b"), m, 8, 640)
    cost = run["cost"]
    assert run["program"] == "engine"
    assert (sum(cost.collective_counts.values()), cost.collective_bytes,
            run["local_params"]) == LANES["7b"]


# ---------------------------------------------------------------------------
# Meta against real tensors; probes against a whole trace
# ---------------------------------------------------------------------------

def test_meta_step_counts_the_flops_of_a_real_cpu_step():
    cfg = get_arch("qwen2-7b").reduced()
    tcfg = TrainConfig(seq_len=32, global_batch=4, microbatch=2,
                       optimizer="sgd", vr="centralvr", vr_table_size=2)
    real_mesh = meshlib.make_test_mesh(device="cpu")
    fn, meta = tstep.make_train_step(cfg, tcfg, real_mesh)
    toks = torch.randint(0, cfg.vocab_size, (meta["accum"], 2, 32),
                         generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        fn(tstep.init_train_state(cfg, tcfg, 1, mesh=real_mesh), toks)
    # the first step of a fresh state, as the dry run's
    real = op_cost.analyze_ops(
        fn, tstep.init_train_state(cfg, tcfg, 1, mesh=real_mesh), toks)
    run = dryrun.dry_train(cfg, tcfg, meshlib.stand_in_mesh(
        (1, 1), ("data", "model")))
    assert run["cost"].flops == counter.get_total_flops() == real.flops > 0
    assert run["cost"].bytes_accessed == real.bytes_accessed


@pytest.mark.parametrize("arch,layers", [("qwen2-7b", 3),
                                         ("recurrentgemma-2b", 5)])
def test_probes_extrapolate_to_the_whole_trace_exactly(arch, layers):
    cfg = dataclasses.replace(get_arch(arch).reduced(), num_layers=layers)
    tcfg = TrainConfig(seq_len=32, global_batch=6, microbatch=2,
                       optimizer="sgd", vr="centralvr", vr_table_size=2)
    m = meshlib.stand_in_mesh((2, 2), ("data", "model"), rank=2)
    whole = dryrun.trace_train(cfg, tcfg, m)
    fit = dryrun.dry_train(cfg, tcfg, m)
    assert fit["extrapolated"]["depths"] == dryrun.depth_probes(cfg)
    assert whole["meta"]["accum"] == 3
    assert op_cost.metrics(fit["cost"]) == op_cost.metrics(whole["cost"],
                                                           shapes=False)
    assert fit["memory"] == whole["memory"]


def test_production_combo_useful_fraction():
    """qwen2-7b train_4k on the pod stand-in, counted at full depth (28
    layers, 16 microbatches): with the heads padded to 32 (``optimized``)
    attention splits over 'model' and the useful fraction lies in
    (0.5, 1]; unpadded, 28 heads do not divide 16, attention runs whole
    on every 'model' rank and the useful fraction is lower."""
    shape = INPUT_SHAPES["train_4k"]
    mesh = dryrun.production_mesh("pod")
    useful = {}
    for opt in (False, True):
        cfg = get_arch("qwen2-7b")
        if opt:
            cfg = dataclasses.replace(cfg, pad_heads_to=32,
                                      param_dtype="bfloat16")
        tcfg = dryrun._combo_tcfg(cfg, shape, False)
        accum, mb = dryrun.train_geometry(tcfg, mesh, "none", 1)
        assert (accum, mb) == (16, 16)
        run = dryrun.fit_train(cfg, dataclasses.replace(tcfg, microbatch=mb),
                               mesh)
        assert "temp_size_in_bytes" not in run["memory"]
        roof = analysis.analyze(cfg, shape, "train", "pod", 256, run["cost"],
                                run["memory"])
        useful[opt] = roof.useful_fraction
    assert 0.5 < useful[True] <= 1
    assert 0 < useful[False] < useful[True]


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_cli_writes_one_record_a_combo(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("OK  mamba2-130m")
    rec = json.loads((tmp_path / "pod" / "mamba2-130m__long_500k.json")
                     .read_text())
    jkeys = {"arch", "shape", "mesh", "paper_mode", "chips", "window",
             "optimized", "pad_heads_to", "workers", "vr", "cost", "memory",
             "roofline"}
    assert jkeys <= set(rec) and "trace_s" in rec and "hlo_bytes" not in rec
    assert rec["chips"] == 256 and rec["program"] == "legacy"
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert set(rec["roofline"]) == {
        f.name for f in dataclasses.fields(analysis.Roofline)}
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                 "--out", str(tmp_path), "--skip-existing"])
    assert capsys.readouterr().out.startswith("SKIP mamba2-130m")


def test_cli_names_a_failing_combo_and_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "FAIL no-such-arch train_4k" in capsys.readouterr().out
