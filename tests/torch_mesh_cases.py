"""The rank side of ``test_torch_mesh.py``: module-level functions that
``launch.mesh.spawn_workers`` runs in each gloo rank on the CPU (this
module imports neither jax nor the reference, so the ranks start fast).

A case is a dict: the arch (reduced, float32), the mesh's shape and axes,
``vr_workers``, ``dp_replicated``, the vr mode and the step count; the
parent passes the reference's initial params and token block as numpy.
"""
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import convert
from repro_torch.config import MeshConfig, TrainConfig, get_arch
from repro_torch.core import spmd
from repro_torch.launch import mesh as meshlib
from repro_torch.models import model, moe
from repro_torch.sharding import gather_ctx, specs, tp
from repro_torch.train import host_loop
from repro_torch.train import step as tstep

STEPS = 5
# the reference params the serve check draws on: qwen2-7b's, W 1
SERVE_REF = ("qwen2-7b", "centralvr", 1)


def cfg_of(arch):
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                               param_dtype="float32")


def tcfg_of(vr, W, dp_replicated=False):
    """A global batch of W workers x 2 microbatches of 4 rows, M = 2."""
    return TrainConfig(seq_len=16, global_batch=8 * W, microbatch=4,
                       optimizer="sgd", learning_rate=0.1, vr=vr,
                       vr_table_size=2, local_epoch=1,
                       dp_replicated=dp_replicated)


def workers_of(case):
    sizes = dict(zip(case["names"], case["shape"]))
    if case["vr"] == "none" or case["workers"] == "none":
        return 1
    axes = (("pod",) if case["workers"] == "pod"
            else tuple(a for a in ("pod", "data") if a in sizes))
    return int(np.prod([sizes.get(a, 1) for a in axes]))


def run_case(case, p0, toks):
    """One case on this rank's mesh, step by step: the losses, the worker
    spread after each step (the largest distance of any rank's params
    from the workers' mean, maxed over the world), the gradient of the
    first step where vr is none, the full params gathered from the
    shards, and the layout's local shapes and specs."""
    cfg = cfg_of(case["arch"])
    W = workers_of(case)
    tcfg = tcfg_of(case["vr"], W, case["dp_replicated"])
    m = meshlib.make_mesh(MeshConfig(case["shape"], case["names"]),
                          device="cpu")
    fn, meta = tstep.make_train_step(cfg, tcfg, m, case["workers"])
    assert meta["workers"] == W
    pl = meta["placement"]
    state = tstep.init_train_state(cfg, tcfg, W, mesh=m,
                                   vr_workers=case["workers"],
                                   params=convert.lm_params_from_jax(p0, cfg))
    tokens = torch.from_numpy(toks)
    world = m.group(m.axis_names)
    losses, spreads, grad = [], [], None
    for s in range(case["steps"]):
        block = tokens[:, s % 2]
        state, out = fn(state, block if W > 1 else block[0])
        losses.append(float(out["loss"]))
        if s == 0 and case["vr"] == "none":
            grad = pl.gather_full(state.grad[None] if state.grad.dim() == 1
                                  else state.grad)
        avg = pl.worker_mean_(state.params.clone())
        spread = (state.params - avg).abs().max().reshape(1)
        spreads.append(float(spmd.pmax_(spread, world)[0]))
    return dict(losses=losses, spreads=spreads, grad=grad,
                local=state.params.clone(), full=pl.gather_full(state.params),
                shapes=[tuple(s) for s in pl.layout.shapes],
                specs=pl.layout.specs, coords=m.coords,
                collectives=m.collectives, carried=m.carried_bytes)


def run_host_loop(case, p0, toks, ev):
    """``host_loop.run_training`` end to end on this rank's mesh."""
    cfg = cfg_of(case["arch"])
    W = workers_of(case)
    m = meshlib.make_mesh(MeshConfig(case["shape"], case["names"]),
                          device="cpu")
    res = host_loop.run_training(
        cfg, tcfg_of(case["vr"], W, case["dp_replicated"]),
        steps=case["steps"], mesh=m, vr_workers=case["workers"],
        log_every=0, params=convert.lm_params_from_jax(p0, cfg),
        tokens=torch.from_numpy(toks), eval_tokens=torch.from_numpy(ev))
    return dict(losses=res.losses, eval=res.final_eval_loss)


def module_checks(group):
    """``gather_ctx.constrain`` and the vocab-parallel embedding and
    cross-entropy on the (data 2, model 2) mesh, against the full
    tensors' autograd in this rank: (name, max abs difference) pairs."""
    cfg = cfg_of("qwen2-7b")
    m = meshlib.make_mesh(MeshConfig((2, 2), ("data", "model")),
                          device="cpu")
    d, f = m.coords
    out = []
    gen = torch.Generator().manual_seed(0)
    full = torch.randn(cfg.d_model, cfg.d_ff, generator=gen)
    cts = [torch.randn(cfg.d_model, cfg.d_ff // 2,
                       generator=torch.Generator().manual_seed(1 + r))
           for r in range(4)]
    rows = slice(d * cfg.d_model // 2, (d + 1) * cfg.d_model // 2)
    cols = slice(f * cfg.d_ff // 2, (f + 1) * cfg.d_ff // 2)
    local = full[rows, cols].clone().requires_grad_()
    with gather_ctx.scope(m, cfg, meshlib.mesh_axis_sizes(m)):
        got = gather_ctx.constrain("ffn/wg", local, tuple(full.shape))
        got.backward(cts[m.rank])
    out.append(("constrain forward", float((got.detach() - full[:, cols])
                                           .abs().max())))
    # the backward sums the cotangents of the data group (same model
    # coordinate), then keeps this rank's rows
    want = sum(cts[q * 2 + f] for q in range(2))[rows]
    out.append(("constrain backward", float((local.grad - want).abs().max())))

    V = cfg.vocab_size
    logits = torch.randn(2, 5, V, generator=gen)
    labels = torch.randint(0, V, (2, 5), generator=gen)
    vcols = slice(f * V // 2, (f + 1) * V // 2)
    loc = logits[..., vcols].clone().requires_grad_()
    ref = logits.clone().requires_grad_()
    F.cross_entropy(ref.reshape(-1, V), labels.reshape(-1)).backward()
    with tp.scope(m, cfg):
        loss = tp.cross_entropy(loc, labels).mean()
        loss.backward()
        tok = torch.randn(V, 8, generator=gen)
        emb = tp.embed(tok[vcols], labels)
    out.append(("cross_entropy", abs(float(loss.detach()) - float(
        F.cross_entropy(ref.reshape(-1, V), labels.reshape(-1))))))
    out.append(("cross_entropy grad", float((loc.grad - ref.grad[..., vcols])
                                            .abs().max())))
    out.append(("embed", float((emb.detach() - tok[labels]).abs().max())))
    return out


def _leaves(tree, prefix=""):
    """(path, leaf) of a params tree of dicts, in order."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out += _leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def moe_checks(group, shape=(2, 2), device="cpu"):
    """``apply_moe`` with its experts and router split over 'model' on the
    (data, model) mesh of ``shape`` (on ``device``; None: the rank's
    card) against the unsplit call in this rank, for
    both MoE archs at capacity factors 0.25 (many drops) and E (none):
    the output, the aux loss, and the gradients of the input, the router,
    the rank's experts and (qwen2-moe) the shared expert and its gate, of
    sum(y * ct) + 3 aux. (name, largest difference over the largest
    magnitude where that is above 1, as ``torch_lm_common.assert_close``
    scales its absolute part) pairs, and the number of experts this rank
    holds of each arch."""
    m = meshlib.make_mesh(MeshConfig(shape, ("data", "model")),
                          device=device)
    sizes = meshlib.mesh_axis_sizes(m)
    out, held = [], {}
    for arch in ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"):
        cfg = cfg_of(arch)
        gen = torch.Generator().manual_seed(0)
        full = moe.init_moe(cfg, lambda shape, init: (torch.randn(
            shape, generator=gen) * 0.2).to(m.device))
        x = torch.randn(2, 32, cfg.d_model, generator=gen).to(m.device)
        ct = torch.randn(x.shape, generator=gen).to(m.device)

        def local_of(path, t):
            spec = specs.leaf_spec(f"ffn/{path}", t.shape, cfg,
                                   axis_sizes=sizes)
            sl = []
            for n, ax in zip(t.shape, spec):
                k, parts = ((m.coords[m.axis_names.index(ax)], sizes[ax])
                            if ax else (0, 1))
                sl.append(slice(k * n // parts, (k + 1) * n // parts))
            return t[tuple(sl)]
        for cf in (0.25, float(cfg.num_experts)):
            ref = model.tree_map(lambda t: t.clone().requires_grad_(), full)
            xr = x.clone().requires_grad_()
            y, aux = moe.apply_moe(ref, cfg, xr, capacity_factor=cf)
            ((y * ct).sum() + 3 * aux).backward()
            loc = {}
            for path, t in _leaves(full):
                node = loc
                *dirs, name = path.split("/")
                for k in dirs:
                    node = node.setdefault(k, {})
                node[name] = local_of(path, t).clone().requires_grad_()
            xl = x.clone().requires_grad_()
            with tp.scope(m, cfg):
                yl, auxl = moe.apply_moe(loc, cfg, xl, capacity_factor=cf)
                ((yl * ct).sum() + 3 * auxl).backward()
            tag = f"{arch} cf {cf:g}"
            held[arch] = loc["wg"].shape[0]
            pairs = [("y", yl, y), ("aux", auxl, aux),
                     ("grad x", xl.grad, xr.grad)]
            pairs += [(f"grad {path}", a.grad, local_of(path, b.grad))
                      for (path, a), (_, b) in zip(_leaves(loc),
                                                   _leaves(ref))]
            for name, got, want in pairs:
                got, want = got.detach(), want.detach()
                scale = max(1.0, float(want.abs().max()))
                out.append((f"{tag} {name}",
                            float((got - want).abs().max()) / scale))
    return out, held


def serve_check(group, p0):
    """The tensor-parallel engine on the (data 2, model 2) mesh (two
    replicas of two TP ranks) over the reference TP test's trace, paged,
    from the reference's params ``p0`` (qwen2-7b reduced, float32)."""
    import torch_serve_tp_cases as tc
    m = meshlib.make_mesh(MeshConfig((2, 2), ("data", "model")),
                          device="cpu")
    cfg = cfg_of("qwen2-7b")
    return tc.serve_ids(cfg, convert.lm_params_from_jax(p0, cfg), "paged",
                        m)


def refusals(group):
    """What a rank of a world of 4 refuses: (name, exception type, text)."""
    out = []
    m = meshlib.make_mesh(MeshConfig((2, 2), ("data", "model")),
                          device="cpu")
    for name, call in (
            ("production", lambda: meshlib.make_production_mesh(
                device="cpu")),
            ("multipod", lambda: meshlib.make_production_mesh(
                multi_pod=True, device="cpu")),
            ("data workers", lambda: tstep.make_train_step(
                cfg_of("qwen2-7b"), tcfg_of("centralvr", 2), m, "data")),
            ("mesh world", lambda: meshlib.make_mesh(
                MeshConfig((4, 2), ("data", "model")), device="cpu"))):
        try:
            call()
            out.append((name, None, ""))
        except Exception as e:      # noqa: BLE001 - reported to the test
            out.append((name, type(e).__name__, str(e)))
    return out


def run_all(group, cases, refs, checks):
    """Every case of this group's world, in order, then the module checks
    and the refusals when asked: {name: result}."""
    out = {}
    for case in cases:
        p0, toks, ev = refs[case["ref"]]
        if case.get("host_loop"):
            out[case["name"]] = run_host_loop(case, p0, toks, ev)
        else:
            out[case["name"]] = run_case(case, p0, toks)
    if checks:
        out["module"] = module_checks(group)
        out["moe"] = moe_checks(group)
        out["serve"] = serve_check(group, refs[SERVE_REF][0])
        out["refusals"] = refusals(group)
    return out
