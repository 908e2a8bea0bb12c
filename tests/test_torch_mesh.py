"""The port's sharded per-step runtime (``train.step.make_train_step`` on
``launch.mesh`` meshes, ``sharding/*``) on gloo ranks on the CPU, in
float32, against the single-device runs of the port and of the JAX
reference on the same params and tokens (the reference's own sharded
tests fail in this container, so the sharded runs are held to its
single-device ones).

One group of 4 ranks and one of 8 are spawned for the module
(``launch.mesh.spawn_workers``) and run every case of their world
(``torch_mesh_cases.py``): (data 2, model 2) — FSDP over 'data' and
tensor parallelism over 'model', CentralVR workers on 'data' with
``dp_replicated``, TP alone with ``dp_replicated``, the reduced
Mamba2-130M and RecurrentGemma-2B, the host loop end to end —,
(data 4, model 1) for both MoE archs, (data 4, model 2) with workers none
and data, and (pod 2, data 2, model 2) with workers on 'pod'. Losses,
the first step's gradient and the final params are held at ``LM_TOL``;
the worker spread is exactly 0 at every epoch boundary; the local shards
have the shapes the specs give. The module checks compare
``gather_ctx.constrain`` and the vocab-parallel embedding and
cross-entropy with full-tensor autograd; the refusals and the launcher's
flags close the file.
"""
import concurrent.futures
import jax
import numpy as np
import pytest
import torch

import torch_mesh_cases as mc
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.data import synthetic as jsynthetic
from repro.launch import train as jlaunch
from repro.train import host_loop as jhost
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train as launch_train
from repro_torch.models import model
from repro_torch.train import host_loop
from repro_torch.train import step as tstep
from torch_lm_common import LM_TOL

torch.set_num_threads(1)

D2M2, D4M1, D4M2 = ((2, 2), ("data", "model")), ((4, 1), ("data", "model")), \
    ((4, 2), ("data", "model"))
P2D2M2 = ((2, 2, 2), ("pod", "data", "model"))


def _case(name, mesh, arch="qwen2-7b", workers="none", dp=False,
          vr="centralvr", steps=mc.STEPS, **kw):
    shape, names = mesh
    case = dict(name=name, arch=arch, shape=shape, names=names,
                workers=workers, dp_replicated=dp, vr=vr, steps=steps, **kw)
    case["ref"] = (arch, vr, mc.workers_of(case))
    return case


CASES_4 = [
    _case("qwen2 d2m2 fsdp+tp", D2M2),
    _case("qwen2 d2m2 workers data", D2M2, workers="data", dp=True),
    _case("qwen2 d2m2 tp dp_replicated", D2M2, dp=True),
    _case("qwen2 d2m2 grad", D2M2, vr="none", steps=2),
    _case("mamba2 d2m2", D2M2, arch="mamba2-130m"),
    _case("recurrentgemma d2m2", D2M2, arch="recurrentgemma-2b"),
    _case("qwen3-moe d4m1", D4M1, arch="qwen3-moe-30b-a3b"),
    _case("qwen2-moe d4m1", D4M1, arch="qwen2-moe-a2.7b"),
    _case("qwen3-moe d2m2", D2M2, arch="qwen3-moe-30b-a3b"),
    _case("qwen2-moe d2m2", D2M2, arch="qwen2-moe-a2.7b"),
    _case("qwen3-moe d2m2 grad", D2M2, arch="qwen3-moe-30b-a3b", vr="none",
          steps=2),
    _case("host loop d2m2 workers data", D2M2, workers="data", dp=True,
          host_loop=True),
]
# three steps in the world of 8 (its ranks share the host's cores): one
# boundary between two local steps
SHORT = 3
CASES_8 = [
    _case("qwen2 d4m2 fsdp+tp", D4M2, steps=SHORT),
    _case("qwen2 d4m2 workers data", D4M2, workers="data", dp=True,
          steps=SHORT),
    _case("qwen2 p2d2m2 workers pod", P2D2M2, workers="pod", steps=SHORT),
]
CASES = CASES_4 + CASES_8
STEPPED = [c["name"] for c in CASES if not c.get("host_loop")]


def _inputs(arch, vr, W):
    """The reference's initial params (worker 0), token block (W, 2, A,
    mb, S) and eval batch, as numpy."""
    jcfg = jget_arch(arch).reduced().__class__(
        **dict(mc.cfg_of(arch).__dict__))
    t = mc.tcfg_of(vr, W)
    jt = JTrainConfig(**t.__dict__)
    accum, mb = jstep.batch_geometry(jt, W)
    state = jax.jit(jstep.init_train_state, static_argnums=(0, 1, 3))(
        jcfg, jt, jax.random.PRNGKey(0), W)
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0] if W > 1 else x),
                                state.params)
    toks = np.array(jsynthetic.epoch_tokens(
        jcfg, jt.seed, workers=W, steps=2, accum=accum, microbatch=mb,
        seq=jt.seq_len, table_size=2))
    ev = np.array(jsynthetic.eval_batch(jcfg, jt.seed, batch=mb,
                                        seq=jt.seq_len))
    return jcfg, jt, p0, toks, ev


def _singles(key, inputs):
    """The single-device runs of one reference key: the reference's host
    loop (5 steps) and the port's (5 steps, and 3 for the params of the
    world of 8), plus (vr none) the first step's gradient of both."""
    arch, vr, W = key
    jcfg, jt, p0, toks, ev = inputs
    cfg = mc.cfg_of(arch)
    ref = jhost.run_training(jcfg, jt, steps=mc.STEPS,
                             workers=W if W > 1 else None, log_every=0)
    lay = model.ParamLayout(cfg)

    def flat(tree):
        return lay.load_(torch.empty(lay.n), convert.lm_params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), cfg))
    ref_params = torch.stack([flat(jax.tree_util.tree_map(
        lambda x, w=w: x[w] if W > 1 else x, ref.state.params))
        for w in range(W)])
    out = dict(ref_losses=np.asarray(ref.losses), ref_eval=ref.final_eval_loss,
               ref_params=ref_params)
    for steps in (mc.STEPS, SHORT):
        port = host_loop.run_training(
            cfg, mc.tcfg_of(vr, W), steps=steps,
            workers=W if W > 1 else None, device="cpu", log_every=0,
            params=convert.lm_params_from_jax(p0, cfg),
            tokens=torch.from_numpy(toks), eval_tokens=torch.from_numpy(ev))
        out[steps] = port.state.params.clone()
        if steps == mc.STEPS:
            out.update(losses=np.asarray(port.losses),
                       eval=port.final_eval_loss)
    if vr == "none" and W == 1:
        _, g = jstep._local_grads(jax.tree_util.tree_map(np.asarray, p0),
                                  jcfg, jt, toks[0, 0], None)
        out["ref_grad"] = flat(g)
        state = tstep.init_train_state(
            cfg, mc.tcfg_of(vr, W), 1, device="cpu",
            params=convert.lm_params_from_jax(p0, cfg))
        tstep._local_grads(state.params[0], state.layout, cfg,
                           mc.tcfg_of(vr, W), torch.from_numpy(toks[0, 0]),
                           state.grad[0])
        out["grad"] = state.grad[0].clone()
    return out


@pytest.fixture(scope="module")
def runs():
    keys = sorted({c["ref"] for c in CASES})
    inputs = {k: _inputs(*k) for k in keys}
    refs = {k: v[2:] for k, v in inputs.items()}
    # the two worlds beside the single-device runs in this process
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut4 = pool.submit(meshlib.spawn_workers, 4, mc.run_all, CASES_4,
                           refs, True, device="cpu", timeout=600)
        fut8 = pool.submit(meshlib.spawn_workers, 8, mc.run_all, CASES_8,
                           refs, False, device="cpu", timeout=600)
        singles = {k: _singles(k, inputs[k]) for k in keys}
        by_rank = {4: fut4.result(), 8: fut8.result()}
    ranks = {c["name"]: [r[c["name"]] for r in by_rank[4 if c in CASES_4
                                                     else 8]]
             for c in CASES}
    return dict(ranks=ranks, singles=singles, four=by_rank[4], refs=refs)


def _by_name(name):
    return next(c for c in CASES if c["name"] == name)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sharded_losses_match_the_single_device_runs(runs, name):
    case = _by_name(name)
    single = runs["singles"][case["ref"]]
    for r in runs["ranks"][name]:
        n = len(r["losses"])
        np.testing.assert_allclose(r["losses"], single["losses"][:n],
                                   **LM_TOL)
        np.testing.assert_allclose(r["losses"], single["ref_losses"][:n],
                                   **LM_TOL)
        # every rank reports the same global loss
        assert r["losses"] == runs["ranks"][name][0]["losses"]
    if case.get("host_loop"):
        for r in runs["ranks"][name]:
            np.testing.assert_allclose(r["eval"], single["eval"], **LM_TOL)
            np.testing.assert_allclose(r["eval"], single["ref_eval"],
                                       **LM_TOL)


@pytest.mark.parametrize("name", [n for n in STEPPED
                                  if _by_name(n)["steps"] != 2])
def test_sharded_params_match_the_single_device_runs(runs, name):
    """Rank 0's full params gathered from every rank's shards, against the
    port's single-device params after as many steps and (5 steps) the
    reference's; every rank gathers the same bits, and the shards put
    back together with ``convert.gather_flat`` give them too."""
    case = _by_name(name)
    single = runs["singles"][case["ref"]]
    res = runs["ranks"][name]
    full = res[0]["full"]
    wants = [single[case["steps"]]]
    if case["steps"] == mc.STEPS:
        wants.append(single["ref_params"])
    for want in wants:
        np.testing.assert_allclose(full.numpy(), want.numpy(), **LM_TOL)
    assert all(torch.equal(r["full"], full) for r in res)
    if mc.workers_of(case) == 1:
        sizes = dict(zip(case["names"], case["shape"]))
        cfg = mc.cfg_of(case["arch"])
        flats = [r["local"][0] for r in res]
        got = convert.gather_flat(flats, cfg, sizes,
                                  fsdp=not case["dp_replicated"])
        assert torch.equal(got, full[0])


def test_sharded_gradient_matches_the_single_device_gradient(runs):
    """The first step's global-batch gradient (vr none), gathered from the
    FSDP x TP shards, against the port's and the reference's."""
    single = runs["singles"][("qwen2-7b", "none", 1)]
    for r in runs["ranks"]["qwen2 d2m2 grad"]:
        got = r["grad"][0]
        for want in (single["grad"], single["ref_grad"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **LM_TOL)


def test_expert_parallel_gradient_matches_the_single_device_gradient(runs):
    """The same for qwen3-moe-30b-a3b with its experts and router split
    over 'model' and FSDP over 'data'."""
    single = runs["singles"][("qwen3-moe-30b-a3b", "none", 1)]
    for r in runs["ranks"]["qwen3-moe d2m2 grad"]:
        got = r["grad"][0]
        for want in (single["grad"], single["ref_grad"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **LM_TOL)


@pytest.mark.parametrize("name", [n for n in STEPPED
                                  if mc.workers_of(_by_name(n)) > 1])
def test_workers_diverge_then_sync(runs, name):
    """CentralVR-Sync on the mesh: the worker copies differ after a local
    step and coincide exactly at every epoch boundary (M*K = 2)."""
    for r in runs["ranks"][name]:
        sp = r["spreads"]
        assert all(x > 0.0 for x in sp[0::2]), sp
        assert all(x == 0.0 for x in sp[1::2]), sp


@pytest.mark.parametrize("name", STEPPED)
def test_local_shards_have_the_shapes_the_specs_give(runs, name):
    case = _by_name(name)
    sizes = dict(zip(case["names"], case["shape"]))
    full = model.ParamLayout(mc.cfg_of(case["arch"])).shapes
    split = 0
    for r in runs["ranks"][name]:
        for shape, spec, f in zip(r["shapes"], r["specs"], full):
            want = []
            for n, ax in zip(f, spec):
                axes = () if ax is None else (ax,) if isinstance(ax, str) \
                    else ax
                want.append(n // int(np.prod([sizes[a] for a in axes])))
            assert shape == tuple(want)
            split += shape != tuple(f)
    assert split > 0
    # the state a rank holds is smaller than the whole
    n_full = model.ParamLayout(mc.cfg_of(case["arch"])).n
    if case["shape"][-1] > 1 and not case["dp_replicated"]:
        r = runs["ranks"][name][0]
        assert r["local"].shape[1] < n_full / 2


def test_collectives_are_counted(runs):
    r = runs["ranks"]["qwen2 d2m2 fsdp+tp"][0]
    assert r["collectives"] > 0 and r["carried"] > 0


def test_module_checks_against_full_tensor_autograd(runs):
    for rank in runs["four"]:
        for name, err in rank["module"]:
            assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
def test_expert_parallel_moe_matches_the_unsplit_moe(runs, arch):
    """``apply_moe`` with each rank holding 2 of the 4 experts and their
    router columns, against the unsplit call, at capacity factors 0.25
    and E: output, aux, and the gradients of the input, the router and
    the rank's experts (and shared expert), scaled as ``assert_close``."""
    for rank in runs["four"]:
        checks, held = rank["moe"]
        assert held[arch] == 2
        mine = [(n, e) for n, e in checks if n.startswith(arch)]
        names = {n.split(" ", 3)[-1] for n, _ in mine}
        assert {"y", "aux", "grad x", "grad router", "grad wg",
                "grad wu", "grad wd"} <= names
        for name, err in mine:
            assert err <= LM_TOL["rtol"], (name, err)


def test_tp_serving_on_data2_model2_gives_the_single_device_ids(runs):
    """``ServeEngine(mesh=...)`` on (data 2, model 2): each data row a
    replica of two tensor-parallel ranks; every rank serves the
    single-device engine's ids in float32 and frees every block."""
    import torch_serve_tp_cases as tc
    cfg = mc.cfg_of("qwen2-7b")
    want = tc.serve_ids(cfg, convert.lm_params_from_jax(
        runs["refs"][mc.SERVE_REF][0], cfg), "paged")
    for rank in runs["four"]:
        got = rank["serve"]
        assert got["ids"] == want["ids"]
        assert got["in_use"] == 0 and got["free"]


def test_refusals_on_a_world_of_four(runs):
    for rank in runs["four"]:
        got = {name: (kind, text) for name, kind, text in rank["refusals"]}
        assert got["production"][0] == "ValueError"
        assert "needs a world of 256 ranks" in got["production"][1]
        assert "world has 4" in got["production"][1]
        assert "needs a world of 512 ranks" in got["multipod"][1]
        assert got["data workers"][0] == "ValueError"
        assert "dp_replicated=True" in got["data workers"][1]
        assert "needs 8 ranks" in got["mesh world"][1]


def test_launcher_flags_are_the_reference_s_plus_device():
    def options(parse):
        import argparse
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, args=None, namespace=None):
            seen.update({a.dest: (tuple(a.option_strings), a.choices,
                                  a.default) for a in self._actions})
            return orig(self, args, namespace)
        argparse.ArgumentParser.parse_args = grab
        try:
            parse(["--arch", "qwen2-7b"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen
    ref, port = options(jlaunch.parse_args), options(launch_train.parse_args)
    assert set(port) == set(ref) | {"device"}
    for dest in ("runtime", "mesh", "workers", "dp_replicated",
                 "checkpoint_every", "resume", "backend"):
        assert port[dest] == ref[dest], dest


def test_launcher_host_runtime_and_its_refusals(capsys):
    base = ["--arch", "qwen2-7b", "--reduced", "--steps", "3",
            "--vr-table-size", "2", "--seq-len", "16", "--global-batch",
            "4", "--microbatch", "2", "--optimizer", "sgd", "--device",
            "cpu", "--runtime", "host"]
    launch_train.main(base)
    out = capsys.readouterr().out
    assert "done: 3 steps" in out and "step     2" in out
    launch_train.main(base + ["--num-workers", "2", "--global-batch", "8",
                              "--dp-replicated", "--workers", "data"])
    assert "done: 3 steps" in capsys.readouterr().out
    for extra, why in (
            (["--backend", "spmd"], "vmap-only"),
            (["--resume", "--checkpoint", "x.npz"], "epoch-scan-runtime"),
            (["--mesh", "production-multipod"], "needs a world of 512"),
            (["--arch", "qwen3-moe-30b-a3b"], None)):
        if why is None:         # a MoE arch on the (1, 1) mesh runs
            launch_train.main(base + extra)
            continue
        with pytest.raises(SystemExit, match=why):
            launch_train.main(base + extra)
    scan = [a for a in base if a not in ("--runtime", "host")]
    for extra in (["--mesh", "production"], ["--workers", "pod"]):
        with pytest.raises(SystemExit, match="pass --runtime host"):
            launch_train.main(scan + extra)
