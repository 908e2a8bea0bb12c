"""Shared by ``tests/test_torch_spmd.py``, the ranks it spawns and the
subprocess that runs the reference's spmd programs: the cases (plain
data), the reference's runs of them, and the function every rank runs.
Imports nothing heavy at the top: the ranks import torch and
``repro_torch`` only, the reference's subprocess jax and ``repro`` only.
It holds no tests of its own.
"""
import dataclasses
import functools

import numpy as np

ROUNDS = 3
N, D = 12, 6                     # samples per worker, features
SEED_DATA, SEED_DRAWS = 2, 7     # PRNGKeys of the data and of the draws
TAU = {"dsaga": 5, "easgd": 4}   # local steps where the default is long


def speeds(p):
    return tuple(1.0 + i for i in range(p))


def _case(algo, p, kind, fused, with_speeds):
    spec = {}
    if algo in TAU:
        spec["tau"] = TAU[algo]
    if with_speeds:
        spec["speeds"] = speeds(p)
    if algo == "dsaga":
        spec["fetch"] = "stale"
    if fused:
        spec["fused"] = True
    name = (f"{algo}-p{p}-{kind}" + ("-fused" if fused else "")
            + ("-speeds" if with_speeds else ""))
    return dict(name=name, algo=algo, p=p, kind=kind, fused=fused,
                spec=spec)


def cases():
    """The eight spmd algorithms at p in {2, 4}, logistic and ridge, fused
    and not (the VR ones), the asynchronous ones round-robin and with
    speeds (1, 2, ...); Algorithm 1 in a group of one rank."""
    out = []
    for p in (2, 4):
        for kind in ("logistic", "ridge"):
            for fused in (False, True):
                for algo, with_speeds in (
                        ("centralvr_sync", False), ("centralvr_async", False),
                        ("centralvr_async", True), ("dsvrg", False),
                        ("dsaga", False), ("dsaga", True)):
                    out.append(_case(algo, p, kind, fused, with_speeds))
            for algo in ("dist_sgd", "easgd", "ps_svrg"):
                out.append(_case(algo, p, kind, False, False))
    for kind in ("logistic", "ridge"):
        for fused in (False, True):
            out.append(_case("centralvr", 1, kind, fused, False))
    return out


# ---------------------------------------------------------------------------
# The reference (jax) side
# ---------------------------------------------------------------------------

def reference_problem(case):
    """(reference problem, eta): p workers of N samples each, or one of N
    for Algorithm 1."""
    return _reference_problem(case["kind"], case["p"],
                              case["algo"] == "centralvr")


@functools.lru_cache(maxsize=None)
def _reference_problem(kind, p, merged):
    import jax

    from repro.config import ConvexConfig
    from repro.core import convex, distributed

    cfg = ConvexConfig(problem=kind, n=N, d=D, workers=p)
    sp = distributed.make_distributed(jax.random.PRNGKey(SEED_DATA), cfg)
    return (sp.merged() if merged else sp), convex.auto_eta(sp.merged(), 0.3)


def reference_run(case, backend):
    """The reference's ``solve`` of a case: (x, rels) as numpy."""
    import jax

    import repro

    prob, eta = reference_problem(case)
    res = repro.solve(repro.RunSpec(case["algo"], p=case["p"], eta=eta,
                                    rounds=ROUNDS, backend=backend,
                                    **case["spec"]),
                      prob, key=jax.random.PRNGKey(SEED_DRAWS))
    return np.asarray(res.x), np.asarray(res.rels)


def reference_spmd(path, ps):
    """The cases of p in ``ps`` through the reference's spmd programs,
    saved to ``path`` (npz): run in a process with forced host devices."""
    out = {}
    for case in (c for c in cases() if c["p"] in ps):
        x, rels = reference_run(case, "spmd")
        out[case["name"] + "/x"], out[case["name"] + "/rels"] = x, rels
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# The LM case: a reduced Qwen2-7B computing in float32, W = 2, seq 32
# ---------------------------------------------------------------------------

def lm_train_kw():
    return dict(seq_len=32, global_batch=4, microbatch=1, optimizer="sgd",
                learning_rate=0.1, vr="centralvr", vr_table_size=2,
                local_epoch=1)


def lm_cfgs(get_arch, TrainConfig):
    cfg = dataclasses.replace(get_arch("qwen2-7b").reduced(),
                              dtype="float32", param_dtype="float32")
    return cfg, TrainConfig(**lm_train_kw())


# ---------------------------------------------------------------------------
# What a rank runs
# ---------------------------------------------------------------------------

def run_jobs(group, jobs, lm_job=None):
    """Run every job (a case with its port problem, eta and draws as
    numpy) through ``repro_torch.solve(backend="spmd")`` in this rank, and
    the LM job if given. Counts the kernel's plain version's calls
    (``vr_epoch_ref``) of each job."""
    import torch

    import repro_torch
    from repro_torch.core.convex import Problem
    from repro_torch.core.distributed import ShardedProblem
    from repro_torch.kernels.vr_update import ref

    calls = []
    plain = ref.vr_epoch_ref

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    ref.vr_epoch_ref = counted
    out = {}
    try:
        for job in jobs:
            A, b = torch.from_numpy(job["A"]), torch.from_numpy(job["b"])
            cls = ShardedProblem if A.ndim == 3 else Problem
            calls.clear()
            res = repro_torch.solve(
                repro_torch.RunSpec(job["algo"], p=job["p"], eta=job["eta"],
                                    rounds=ROUNDS, backend="spmd",
                                    **job["spec"]),
                cls(A, b, job["lam"], job["kind"]), orders=job["orders"],
                group=group)
            state = res.state
            tensors = ({f: getattr(state, f) for f in state._fields}
                       if hasattr(state, "_fields") else {"x": state})
            out[job["name"]] = dict(
                x=res.x, rels=res.rels, plain_calls=len(calls),
                launches=res.launches, device=res.device,
                shapes={f: tuple(t.shape) for f, t in tensors.items()},
                devices={f: str(t.device) for f, t in tensors.items()},
                carried=res.comms["carried_bytes"],
                collectives=res.comms["collectives"], rank=group.rank,
                world=group.world, transport=group.transport)
    finally:
        ref.vr_epoch_ref = plain
    if lm_job is not None:
        out["lm"] = _run_lm(group, lm_job)
    return out


def _run_lm(group, job):
    """Two epochs of the spmd epoch runner (fused: the kernels' plain
    versions on the CPU) from the reference's params and token block."""
    import torch

    from repro_torch import convert
    from repro_torch.config import TrainConfig, get_arch
    from repro_torch.train import step as tstep

    cfg, tcfg = lm_cfgs(get_arch, TrainConfig)
    run, meta = tstep.make_epoch_runner(
        cfg, tcfg, 2, backend="spmd", fused=True, group=group,
        tokens=convert.tokens_from_jax(job["toks"]))
    state = tstep.init_train_state(
        cfg, tcfg, 2, params=convert.lm_params_from_jax(job["p0"], cfg),
        device=group.device)
    state = tstep.place_train_state(state, group)
    losses = []
    for _ in range(2):
        state, ls = run(state)
        losses.append(ls)
    return dict(losses=torch.cat(losses), params=state.params.clone(),
                gbar=state.vr_state.gbar.clone(),
                shapes=[tuple(t.shape) for t in
                        (state.params, state.grad, state.vr_state.gbar,
                         *state.vr_state.table)],
                group_in_meta=meta["group"] is group)


def fail_on_rank_one(group):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch

    from repro_torch.core import spmd

    if group.rank == 1:
        raise ArithmeticError("rank one gives up")
    spmd.pmean(torch.ones(3, dtype=torch.float64), group)
    return group.rank
