"""Multi-pod dry run of the port — ``repro/launch/dryrun.py``: every
(architecture x input shape) on the production meshes, WITHOUT allocating
any model memory and without a world of 256 or 512 ranks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 x pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh pod [--paper-mode]

Rank 0 of a stand-in mesh (``launch.mesh.stand_in_mesh``: the production
mesh's groups, which record their collectives instead of communicating)
builds its sharded state on ``torch.device("meta")`` and runs the combo's
program once under ``roofline.op_cost.analyze_ops``. Per combo it writes
the op-cost record, the memory of the rank and the roofline terms to
``results/dryrun_torch/<mesh>/<arch>__<shape>[__paper].json``, one line
printed a combo.

Baseline configuration (the reference's): CentralVR as optimizer (table
M=4 below 20B params, SVRG above), FSDP sharding, SGD base step, on the
multi-pod mesh the CentralVR workers are the two pods. ``--paper-mode``
replicates params along the data axes with one CentralVR worker per
data-axis group (Algorithm 2's literal memory model).

Training combos run one ``train.step.make_train_step`` step (``fused``
off: plain attention and plain autograd, no kernel runs on meta). Decode
and prefill combos run the tensor-parallel program of
``ServeEngine(mesh=...)``: the rank's shards of ``serve.engine.tp_params``'
layout on meta (TP over 'model', no FSDP), a dense cache of the shape's
sequence length, under ``sharding.tp.scope``. A data group of serving is an
independent replica that serves B / data of the batch and runs no
collective over 'data'; prefill runs each of its sequences as one chunk.

The ops run on meta tensors one Python dispatch at a time, and a step of
the production shapes dispatches millions of them (the plain attention's
chunk loop alone is some 10^4 ops a layer and microbatch at 4096 tokens).
So a combo deeper than its probes is traced at a few small depths and
repetitions, and every count is extrapolated (:func:`fit_affine`): the
layers of one kind run the same ops on the same shapes, as do the
microbatches of a step (or the sequences of a prefill), so each count is
affine in the number of layers of each kind and in the repetitions, and
exactly so; the fit is exact arithmetic and refuses probes that disagree
with it (:func:`fit_train`). The peak of a step (``temp_size_in_bytes``)
is no such sum (it lies where the live storages are most, which moves
with the depth), so it comes from one step of the whole stack at one
microbatch (:func:`train_peak`): the microbatches run one after another
and free what they allocate, so the peak does not depend on how many
there are. A record says which probes its counts came from
(``extrapolated``); the lanes that ``chip_smoke.py`` and the tests hold
against the card's counts, the decode steps and the prefills are traced
whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from fractions import Fraction

import torch


def _combo_tcfg(cfg, shape, paper_mode: bool):
    from repro_torch.config import TrainConfig
    big = cfg.param_count() > 2e10
    return TrainConfig(
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        microbatch=1,
        optimizer="sgd",
        vr="svrg" if big else "centralvr",
        vr_table_size=4,
        local_epoch=1,
        remat="block",
        dp_replicated=paper_mode,
    )


def _arch_window(cfg, shape):
    """long_500k on quadratic-attention archs uses the sliding-window
    variant (window 4096), as the reference does."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return 4096
    return None


def _tensors(obj, out=None) -> list:
    """The tensors of a state (dataclasses, named tuples, lists, dicts)."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    return out


def state_bytes(*objs) -> int:
    """Bytes of the distinct storages that ``objs`` hold."""
    seen, n = set(), 0
    for t in _tensors(list(objs)):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def _memory(cost, args, result, inputs: int = 0) -> dict:
    """The rank's memory: its state and ``inputs`` bytes of its inputs
    (arguments), what the call returns (the state it updates in place
    included), and the call's own peak (``OpCost.temp_size_in_bytes``)."""
    return {"argument_size_in_bytes": state_bytes(*args) + inputs,
            "output_size_in_bytes": state_bytes(result),
            "temp_size_in_bytes": cost.temp_size_in_bytes}


def train_geometry(tcfg, mesh, vr_workers: str, W: int):
    """(accum, microbatch) of a train combo, the reference's rule: the
    microbatch is the product of the data axes that carry no workers
    (each rank holds one sequence a microbatch step), accumulation
    covers the rest of the global batch."""
    from repro_torch.launch import mesh as meshlib
    sizes = meshlib.mesh_axis_sizes(mesh)
    w_axes = (meshlib.worker_axes(mesh, vr_workers) if tcfg.vr != "none"
              else ())
    R = 1
    for a in ("pod", "data"):
        if a in sizes and a not in w_axes:
            R *= sizes[a]
    mb = min(R, max(tcfg.global_batch // W, 1))
    accum = max(tcfg.global_batch // (W * mb), 1)
    return accum, mb


# ---------------------------------------------------------------------------
# Extrapolation over layers and repetitions
# ---------------------------------------------------------------------------

MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes")


def depth_probes(cfg) -> tuple:
    """The depths a deep combo is traced at: 1 up to one past the first
    depth whose layers hold every kind of the full stack."""
    kinds = set(cfg.layer_kinds())
    probe = dataclasses.replace(cfg, num_layers=1)
    d = 1
    while set(probe.layer_kinds()) != kinds:
        d += 1
        probe = dataclasses.replace(cfg, num_layers=d)
    return tuple(range(1, d + 2))


def _solve_exact(rows, values):
    """The coefficients c with ``rows @ c == values`` exactly (Fractions);
    raises when the rows do not fix them or the values contradict each
    other."""
    n = len(rows[0])
    aug = [[Fraction(x) for x in r] + [Fraction(v)]
           for r, v in zip(rows, values)]
    piv, at = [], 0
    for col in range(n):
        hit = next((i for i in range(at, len(aug)) if aug[i][col] != 0),
                   None)
        if hit is None:
            raise ValueError("the probes do not fix the affine model")
        aug[at], aug[hit] = aug[hit], aug[at]
        top = aug[at]
        for i in range(len(aug)):
            if i != at and aug[i][col] != 0:
                f = aug[i][col] / top[col]
                aug[i] = [a - f * b for a, b in zip(aug[i], top)]
        piv.append(at)
        at += 1
    if any(r[-1] != 0 for r in aug[at:]):
        raise ValueError("the probes are not affine in the layers and "
                         "repetitions")
    return [aug[i][-1] / aug[i][i] for i in piv]


def fit_affine(trace, cfg, reps: int) -> dict:
    """Every count of the full combo from probes: ``trace(depth, r)``
    returns a flat map of counts of ``cfg`` cut to ``depth`` layers at
    ``r`` repetitions (the microbatches of a step). Each count is fitted
    as ``a + sum_k n_k b_k + r (c + sum_k n_k e_k)`` (n_k the layers of
    kind k) and evaluated at the full depth and ``reps``."""
    names = sorted(set(cfg.layer_kinds()))
    rs = (1, 2) if reps >= 2 else (1,)

    def counts(kinds):
        return [sum(k == n for k in kinds) for n in names]

    samples = []
    for d in depth_probes(cfg):
        n = counts(dataclasses.replace(cfg, num_layers=d).layer_kinds())
        for r in rs:
            samples.append((n, r, trace(d, r)))
    full_n = counts(cfg.layer_kinds())

    def feats(n, r):
        base = [1] + n
        return base + [r * x for x in base] if len(rs) == 2 else base

    keys = set().union(*(m for _, _, m in samples))
    out = {}
    for key in keys:
        try:
            coef = _solve_exact([feats(n, r) for n, r, _ in samples],
                                [m.get(key, 0) for _, _, m in samples])
        except ValueError as e:
            raise ValueError(f"{key}: {e}") from None
        out[key] = float(sum(c * x for c, x in zip(coef,
                                                   feats(full_n, reps))))
    return out


def dry_train(cfg, tcfg, mesh, vr_workers: str = "none") -> dict:
    """One ``make_train_step`` step of ``mesh.rank`` on meta tensors: its
    cost, memory, the step's meta and the params the rank holds. Traced
    whole under ``analyze_ops`` when the stack is no deeper than its
    probes and the step has at most 2 microbatches; else the counts come
    from :func:`fit_train` and the peak from :func:`train_peak`.
    ``tcfg.microbatch`` sets the geometry."""
    from repro_torch.train import step as tstep

    _, meta = tstep.make_train_step(cfg, tcfg, mesh, vr_workers,
                                    fused=False)
    if cfg.num_layers <= depth_probes(cfg)[-1] and meta["accum"] <= 2:
        return trace_train(cfg, tcfg, mesh, vr_workers)
    run = fit_train(cfg, tcfg, mesh, vr_workers)
    run["memory"]["temp_size_in_bytes"] = train_peak(cfg, tcfg, mesh,
                                                     vr_workers)
    return run


def fit_train(cfg, tcfg, mesh, vr_workers: str = "none") -> dict:
    """The counts of one step, fitted from probes (:func:`fit_affine`):
    its cost, argument and output memory (no peak), meta and the params
    the rank holds."""
    from repro_torch.roofline import op_cost
    from repro_torch.train import step as tstep

    _, meta = tstep.make_train_step(cfg, tcfg, mesh, vr_workers,
                                    fused=False)
    A, W, mb = meta["accum"], meta["workers"], meta["microbatch"]

    def trace(d, r):
        run = trace_train(dataclasses.replace(cfg, num_layers=d),
                          dataclasses.replace(tcfg, global_batch=W * mb * r),
                          mesh, vr_workers)
        m = op_cost.metrics(run["cost"], shapes=False)
        m.update({(k,): run["memory"][k] for k in MEMORY_KEYS})
        return m
    m = fit_affine(trace, cfg, A)
    memory = {k: int(m.pop((k,))) for k in MEMORY_KEYS}
    return dict(cost=op_cost.from_metrics(m), memory=memory, meta=meta,
                local_params=meta["placement"].layout.n,
                extrapolated={"depths": depth_probes(cfg),
                              "microbatches": (1, 2)})


def train_peak(cfg, tcfg, mesh, vr_workers: str = "none") -> int:
    """The step's ``temp_size_in_bytes``: the whole stack at one
    microbatch (the microbatches run one after another and free what
    they allocate, so the peak does not depend on their number)."""
    W = 1
    if tcfg.vr != "none":
        from repro_torch.launch import mesh as meshlib
        W = meshlib.worker_count(mesh, vr_workers)
    one = trace_train(cfg, dataclasses.replace(
        tcfg, global_batch=W * tcfg.microbatch), mesh, vr_workers)
    return one["memory"]["temp_size_in_bytes"]


def trace_train(cfg, tcfg, mesh, vr_workers: str = "none") -> dict:
    """One ``make_train_step`` step of ``mesh.rank`` on meta tensors,
    traced whole under ``analyze_ops``."""
    from repro_torch.roofline import op_cost
    from repro_torch.train import step as tstep

    fn, meta = tstep.make_train_step(cfg, tcfg, mesh, vr_workers,
                                     fused=False)
    W = meta["workers"]
    state = tstep.init_train_state(cfg, tcfg, W, mesh=mesh,
                                   vr_workers=vr_workers, device="meta")
    lead = (W,) if W > 1 else ()
    toks = torch.empty(lead + (meta["accum"], meta["microbatch"],
                               tcfg.seq_len), dtype=torch.int64,
                       device="meta")
    pl = meta["placement"]
    mine = pl.local_tokens(toks, mesh.device, meta["accum"],
                           meta["microbatch"], tcfg.seq_len)
    cost = op_cost.analyze_ops(fn, state, toks, mesh=mesh)
    return dict(cost=cost,
                memory=_memory(cost, (state,), cost.result,
                               mine.numel() * mine.element_size()),
                meta=meta, local_params=pl.layout.n)


def serve_width(B: int, mesh) -> int:
    """The lanes one serving replica runs: B split over the 'pod' and
    'data' axes that divide it (each group along them is a replica)."""
    from repro_torch.launch import mesh as meshlib
    sizes = meshlib.mesh_axis_sizes(mesh)
    for a in ("pod", "data"):
        if a in sizes and B % sizes[a] == 0:
            B //= sizes[a]
    return B


def engine_serves(cfg) -> bool:
    """Whether the serving engine takes ``cfg`` (attention-family blocks,
    no frontend); the others serve on the legacy loop's program."""
    from repro_torch.serve import runtime
    try:
        runtime.check_arch(cfg)
    except ValueError:
        return False
    return True


def _serve_setup(cfg, mesh, width: int, context: int):
    from repro_torch.serve import runtime
    from repro_torch.serve.cache import Geometry
    from repro_torch.train.step import ShardedLayout
    block = 16
    bps = -(-context // block)
    geo = Geometry(width=width, block_size=block, blocks_per_seq=bps,
                   num_blocks=1 + width * bps, kv_cache="dense")
    # the rank's shards of ``engine.tp_params``: its layout, no FSDP
    params = _meta_params(cfg, ShardedLayout(
        cfg, mesh.axis_names, mesh.shape, mesh.coords, fsdp=False))
    cache = runtime.init_cache(cfg, geo, device=mesh.device)
    return geo, params, cache


def _meta_params(cfg, lay):
    """The params tree of ``lay`` (the whole ``ParamLayout`` or a rank's
    ``ShardedLayout``) on meta, cast as serving casts it."""
    from repro_torch.serve import runtime
    dtype = getattr(torch, cfg.param_dtype)
    params = lay.unflatten([torch.empty(shp, dtype=dtype, device="meta")
                            for shp in lay.shapes])
    return runtime.cast_params(params, cfg, torch.device("meta"))


def dry_decode(cfg, mesh, width: int, context: int) -> dict:
    """One decode step at ``width`` lanes over a cache of ``context``
    positions on meta tensors, under ``analyze_ops``: the serving
    engine's tensor-parallel program over a dense cache, or, for an arch
    the engine does not take, the legacy loop's lockstep step
    (``model.decode_step``) on the whole params (the legacy loop has no
    mesh)."""
    from repro_torch.models import model
    from repro_torch.roofline import op_cost
    from repro_torch.serve import runtime
    from repro_torch.sharding import tp

    meta = dict(dtype=torch.int64, device="meta")
    if not engine_serves(cfg):
        params = _meta_params(cfg, model.ParamLayout(cfg))
        cache = model.init_cache(cfg, width, context, device="meta")
        args = (params, torch.empty(width, 1, **meta), cache)
        cost = op_cost.analyze_ops(
            lambda p, t, c: model.decode_step(p, cfg, t, c, context - 1),
            *args)
        return dict(cost=cost, memory=_memory(cost, args, cost.result),
                    local_params=model.param_count_actual(params),
                    program="legacy")
    geo, params, cache = _serve_setup(cfg, mesh, width, context)
    decode, _ = runtime.build_programs(cfg, geo)
    args = (params, cache, torch.empty(width, **meta),
            torch.empty(width, **meta), torch.empty(width, **meta),
            torch.empty(width, geo.blocks_per_seq, **meta))

    def step(*a):
        with tp.scope(mesh, cfg):
            return decode(*a)
    cost = op_cost.analyze_ops(step, *args, mesh=mesh)
    return dict(cost=cost, memory=_memory(cost, args, cost.result),
                local_params=model.param_count_actual(params),
                program="engine")


def dry_prefill(cfg, mesh, width: int, seq_len: int) -> dict:
    """The prefill of ``width`` sequences of ``seq_len`` tokens on meta
    tensors, under ``analyze_ops``: by the serving engine's
    tensor-parallel program, each sequence one chunk, or, for an arch the
    engine does not take, by one forward of the whole params over the
    batch (the reference's ``serve_prefill``; frontend archs take their
    frontend embeddings in place of the first tokens)."""
    from repro_torch.models import model
    from repro_torch.roofline import op_cost
    from repro_torch.serve import runtime
    from repro_torch.sharding import tp
    from repro_torch.train import step as tstep

    if not engine_serves(cfg):
        params = _meta_params(cfg, model.ParamLayout(cfg))
        n_f = cfg.frontend_tokens if cfg.frontend else 0
        toks = torch.empty(width, seq_len - n_f, dtype=torch.int64,
                           device="meta")
        fe = (torch.empty(width, n_f, cfg.d_model,
                          dtype=getattr(torch, cfg.dtype), device="meta")
              if n_f else None)
        _, prefill = tstep.make_serve_step(cfg)
        args = (params, toks, fe)
        cost = op_cost.analyze_ops(prefill, *args)
        return dict(cost=cost, memory=_memory(cost, args, cost.result),
                    local_params=model.param_count_actual(params),
                    program="legacy")
    geo, params, cache = _serve_setup(cfg, mesh, width, seq_len)
    _, prefill = runtime.build_programs(cfg, geo)
    toks = torch.empty(seq_len, dtype=torch.int64, device="meta")
    row = torch.empty(geo.blocks_per_seq, dtype=torch.int64, device="meta")
    args = (params, cache, toks, row)

    def fill(params, cache, toks, row):
        out = []
        with tp.scope(mesh, cfg):
            for lane in range(width):
                logits, cache = prefill(params, cache, toks, 0, seq_len,
                                        lane, row)
                out.append(logits)
        return out, cache
    cost = op_cost.analyze_ops(fill, *args, mesh=mesh)
    return dict(cost=cost, memory=_memory(cost, args, cost.result),
                local_params=model.param_count_actual(params),
                program="engine")


def production_mesh(mesh_name: str, rank: int = 0):
    """Rank ``rank`` of the stand-in for ``make_production_mesh``:
    (data 16, model 16), or (pod 2, data 16, model 16) for multipod."""
    from repro_torch.launch import mesh as meshlib
    if mesh_name == "multipod":
        return meshlib.stand_in_mesh((2, 16, 16), ("pod", "data", "model"),
                                     rank)
    return meshlib.stand_in_mesh((16, 16), ("data", "model"), rank)


def run_combo(arch: str, shape_name: str, mesh_name: str,
              paper_mode: bool = False, out_dir: str = "results/dryrun_torch",
              optimized: bool = False):
    """One combo's record (and its file). ``optimized``: the reference's
    beyond-paper layout wins that the port has — TP head padding to a
    multiple of 16, and bfloat16 master params in training (serving is
    TP-only here in both modes)."""
    from repro_torch.config import INPUT_SHAPES, get_arch
    from repro_torch.roofline import analysis

    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    window = _arch_window(cfg, shape)
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    if (optimized and any(k in ("attn", "local") for k in cfg.layer_kinds())
            and cfg.num_heads % 16):
        cfg = dataclasses.replace(
            cfg, pad_heads_to=((cfg.num_heads + 15) // 16) * 16)

    mesh = production_mesh(mesh_name)
    chips = mesh.world
    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "paper_mode": paper_mode, "chips": int(chips),
              "window": window, "optimized": optimized,
              "pad_heads_to": cfg.pad_heads_to}

    if shape.mode == "train":
        if optimized:
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        tcfg = _combo_tcfg(cfg, shape, paper_mode)
        vr_workers = ("data" if paper_mode else
                      ("pod" if mesh_name == "multipod" else "none"))
        from repro_torch.launch import mesh as meshlib
        W = (meshlib.worker_count(mesh, vr_workers) if tcfg.vr != "none"
             else 1)
        accum, mb = train_geometry(tcfg, mesh, vr_workers, W)
        tcfg = dataclasses.replace(tcfg, microbatch=mb)
        run = dry_train(cfg, tcfg, mesh, vr_workers)
        meta = run["meta"]
        record.update(workers=meta["workers"], accum=meta["accum"],
                      microbatch=meta["microbatch"], vr=tcfg.vr,
                      comm_every=meta["comm_every"])
    else:
        width = serve_width(shape.global_batch, mesh)
        if shape.mode == "prefill":
            run = dry_prefill(cfg, mesh, width, shape.seq_len)
        else:
            run = dry_decode(cfg, mesh, width, shape.seq_len)
        record.update(workers=0, vr="none", width=width,
                      program=run["program"])
    trace_s = time.time() - t0

    cost, mem = run["cost"], run["memory"]
    roof = analysis.analyze(cfg, shape, shape.mode, mesh_name, chips, cost,
                            mem)
    if "extrapolated" in run:
        record["extrapolated"] = run["extrapolated"]
    record.update(
        trace_s=round(trace_s, 1),
        cost={"flops": cost.flops, "bytes accessed": cost.bytes_accessed},
        memory=mem, local_params=run["local_params"],
        roofline=roof.to_dict())

    suffix = "__paper" if paper_mode else ""
    mesh_dir = mesh_name + ("_opt" if optimized else "")
    path = os.path.join(out_dir, mesh_dir,
                        f"{arch}__{shape_name}{suffix}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"OK  {arch:20s} {shape_name:12s} {mesh_name:8s}"
          f"{' paper' if paper_mode else ''}  "
          f"trace {trace_s:.0f}s  "
          f"bottleneck={roof.bottleneck}  "
          f"Tc={roof.t_compute*1e3:.1f}ms Tm={roof.t_memory*1e3:.1f}ms "
          f"Tx={roof.t_collective*1e3:.2f}ms", flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--paper-mode", action="store_true")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.config import INPUT_SHAPES, list_archs

    if args.all:
        combos = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("pass --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    failures = []
    mesh_dir = args.mesh + ("_opt" if args.optimized else "")
    for arch, shape in combos:
        suffix = "__paper" if args.paper_mode else ""
        path = os.path.join(args.out, mesh_dir, f"{arch}__{shape}{suffix}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"SKIP {arch} {shape} (exists)")
            continue
        try:
            run_combo(arch, shape, args.mesh, args.paper_mode, args.out,
                      optimized=args.optimized)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} {shape}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall combos traced")


if __name__ == "__main__":
    main()
