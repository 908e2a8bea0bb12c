#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper
card, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. device: name, compute capability (must be 9.0), name and power limit
     as nvidia-smi reports them;
  2. build: compiles the hand-written CUDA kernel ``vr_update`` from the
     checkout's sources (nvcc, sm_90a), timed;
  3. kernel against its plain PyTorch version on the card, at the main
     path's shapes (8, 1000) and (1, 90), float64 and float32, SAGA off
     and on, decay 0 and 2e-4, prox none / l1 / elasticnet / box:
     largest absolute error <= 1e-12 in float64, <= 1e-6 of the largest
     magnitude in float32;
  4. main path, float64, through ``repro_torch.solve`` with fused=True:
     CentralVR-Sync (Algorithm 2) at p=8 on the paper's §6.2
     ``dist-toy-logistic`` (n=5000 per worker, d=1000) and CentralVR
     (Algorithm 1) on ``millionsong`` (n=46371, d=90), 10 rounds each.
     The kernel's launch count must grow by exactly the number of inner
     steps; the trajectory must match the unfused run with the same
     visit orders to 1e-9; every rel must be finite and the last below
     the first;
  5. the ``kernels`` line: per kernel its launches on the main path, its
     device time per launch and its plain version's (CUDA-graph replay of
     back-to-back calls at the Algorithm-2 shape), its bound on this card
     and its largest error against the plain version.

With ``--profile`` it then traces 2000 fused inner steps of each path
with ``torch.profiler`` and prints the device time per step, the device
busy share against the same steps run untraced, and the kernels that
take the device time.

TF32 is off for matrix products and convolutions, so float32 products
are full float32 (the main path runs in float64 anyway).

Without a CUDA device it exits with status 1 and prints no result. The
last line of its output is ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core
# FLOP/s by type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
# operations per element of the main path's launch (saga off, no prox):
# v = g - g_old + gbar (2), x*scale - eta*v (3), gtilde + g*inv_m (2)
VR_OPS_PER_ELEMENT = 7
# arrays of the (p, d) batch the main path's launch moves once each: reads
# x, g, g_old, gbar, gtilde; writes x', gtilde' (gbar' only with SAGA, and
# table' is g itself)
VR_STREAMS = 7
ROUNDS = 10


def log(*args):
    print(*args, flush=True)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {name}  capability {cap}  count "
        f"{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    if cap != (9, 0):
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(vr_kernel):
    t0 = time.perf_counter()
    lib = vr_kernel.build()
    vr_kernel._load()
    dt = time.perf_counter() - t0
    log(f"[build] vr_update: {lib.name} in {dt:.2f} s")
    for line in vr_kernel.build_log.splitlines():
        if "ptxas" in line:
            log(f"[build]   {line.strip()}")
    return dt


def phase_compare(torch, np, vr_kernel, vr_ref, proxops):
    worst = {"float64": 0.0, "float32": 0.0}
    cases = 0
    for shape in ((8, 1000), (1, 90)):
        for dtype in (torch.float64, torch.float32):
            for saga in (False, True):
                for decay in (0.0, 2e-4):
                    for prox in (None, "l1:0.05", "elasticnet:0.05:0.3",
                                 "box:-0.2:0.3"):
                        rng = np.random.default_rng(cases)
                        ts = [torch.from_numpy(rng.standard_normal(shape))
                              .to("cuda", dtype) for _ in range(5)]
                        kw = dict(eta=0.3, m=shape[1] * 5, saga=saga,
                                  decay=decay,
                                  prox=proxops.parse(prox) if prox else None)
                        got = vr_kernel.vr_update(*ts, **kw)
                        torch.cuda.synchronize()
                        want = vr_ref.vr_update_ref(*ts, **kw)
                        # in place: x', gtilde', gbar' written into the inputs
                        inplace = vr_kernel.vr_update(
                            *[t.clone() for t in ts], inplace=True, **kw)
                        torch.cuda.synchronize()
                        key = str(dtype).split(".")[-1]
                        for w, h, i in zip(want, got, inplace):
                            err = max((h - w).abs().max().item(),
                                      (i - w).abs().max().item())
                            scale = w.abs().max().item()
                            bound = 1e-12 if key == "float64" else 1e-6 * scale
                            if not err <= bound:
                                raise AssertionError(
                                    f"vr_update {shape} {key} saga={saga} "
                                    f"decay={decay} prox={prox}: max abs err "
                                    f"{err} > {bound}")
                            worst[key] = max(worst[key], err)
                        cases += 1
    log(f"[compare] vr_update kernel vs plain version: {cases} cases, max "
        f"abs err float64 {worst['float64']!r}, float32 {worst['float32']!r}")
    return worst


def drive(torch, solve, spec_kw, cfg, orders, vr_kernel, label):
    """One main-path run with the kernel and its unfused twin on the same
    orders; returns the fused run's record."""
    import numpy as np

    from repro_torch import RunSpec

    steps = ROUNDS * cfg.n          # one launch per inner step
    total = (ROUNDS + 1) * cfg.n    # inner steps with the init epoch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vr_kernel.reset_launches()
    t0 = time.perf_counter()
    fused = solve(RunSpec(fused=True, **spec_kw), cfg, orders=orders)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = vr_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != steps or fused.launches["vr_update"] != steps:
        raise AssertionError(f"{label}: vr_update launched {launches} times, "
                             f"expected one per inner step ({steps})")
    t1 = time.perf_counter()
    unfused = solve(RunSpec(fused=False, **spec_kw), cfg, orders=orders)
    torch.cuda.synchronize()
    wall_u = time.perf_counter() - t1
    rels, rels_u = fused.rels, unfused.rels
    diff = max(float(abs(rels - rels_u).max()),
               float(abs(fused.x - unfused.x).max()))
    log(f"[path] {label}: rels {[float(r) for r in rels]}")
    log(f"[path] {label}: unfused rels {[float(r) for r in rels_u]}")
    log(f"[path] {label}: fused wall {wall:.3f} s ({total / wall:.1f} inner "
        f"steps/s, init epoch included), unfused wall {wall_u:.3f} s, "
        f"launches {launches}, peak memory {peak / 2**20:.1f} MiB, "
        f"max |fused - unfused| {diff!r}, eta {fused.spec.eta!r}")
    if not (len(rels) == ROUNDS and np.isfinite(rels).all()):
        raise AssertionError(f"{label}: rels not finite: {rels}")
    if not rels[-1] < rels[0]:
        raise AssertionError(f"{label}: no progress, rels {rels}")
    if not diff <= 1e-9:
        raise AssertionError(f"{label}: fused and unfused differ by {diff}")
    return dict(label=label, launches=launches, wall_s=wall,
                unfused_wall_s=wall_u, steps=steps, peak_bytes=peak,
                rels=[float(r) for r in rels], max_diff=diff)


def phase_main_path(torch, vr_kernel):
    from repro_torch import solve
    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import centralvr, distributed

    gen = torch.Generator(device="cuda").manual_seed(0)
    dist = PRESETS["dist-toy-logistic"]
    sync_orders = distributed.draw_sync_orders(gen, dist.workers, dist.n,
                                               ROUNDS)
    ms = PRESETS["millionsong"]
    cvr_orders = centralvr.draw_orders(gen, ms.n, ROUNDS)
    return [
        drive(torch, solve, dict(algo="centralvr_sync", p=dist.workers,
                                 rounds=ROUNDS), dist, sync_orders, vr_kernel,
              "centralvr_sync p=8 dist-toy-logistic (5000x1000 per worker)"),
        drive(torch, solve, dict(algo="centralvr", rounds=ROUNDS), ms,
              cvr_orders, vr_kernel,
              "centralvr millionsong (46371x90)"),
    ]


def graph_ms(torch, fn, calls=200, replays=20):
    """Device time per call of ``fn``: ``calls`` back-to-back calls
    captured in one CUDA graph, replayed, timed with CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(torch, fn, calls=2000):
    """Wall time per call of ``fn`` issued from Python, as the epoch loop
    issues it (host launch cost included)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def time_vr_update(torch, np, vr_kernel, vr_ref, shape):
    rng = np.random.default_rng(1)
    ts = [torch.from_numpy(rng.standard_normal(shape)).cuda()
          for _ in range(5)]
    kw = dict(eta=1e-3, m=shape[1] * 5, saga=False, decay=2e-4, prox=None)
    kernel = lambda: vr_kernel.vr_update(*ts, inplace=True, **kw)  # noqa: E731
    plain = lambda: vr_ref.vr_update_ref(*ts, **kw)                 # noqa: E731
    elems = shape[0] * shape[1]
    itemsize = ts[0].element_size()
    bytes_s = VR_STREAMS * elems * itemsize / PEAK_BYTES_S
    ops_s = VR_OPS_PER_ELEMENT * elems / PEAK_FLOPS["float64"]
    rec = dict(shape=list(shape), dtype="float64",
               ms=graph_ms(torch, kernel), plain_ms=graph_ms(torch, plain),
               eager_ms=eager_ms(torch, kernel),
               plain_eager_ms=eager_ms(torch, plain),
               bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="bytes" if bytes_s >= ops_s else "operations")
    log(f"[time] vr_update {shape} float64: kernel {rec['ms']!r} ms/launch "
        f"(graph replay), {rec['eager_ms']!r} ms/launch from Python; plain "
        f"{rec['plain_ms']!r} ms (graph), {rec['plain_eager_ms']!r} ms "
        f"(Python); bound {rec['bound_ms']!r} ms ({rec['bound_by']})")
    return rec


def phase_profile(torch, steps=2000):
    """Where a fused inner step's time goes: device time per step and the
    device's busy share, from ``torch.profiler`` over ``steps`` steps of
    each path's fused epoch body (from a zero state: the values do not
    change the work)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import centralvr, convex, distributed
    from repro_torch.core import fused as fusedmod

    gen = torch.Generator(device="cuda").manual_seed(1)
    dist, ms = PRESETS["dist-toy-logistic"], PRESETS["millionsong"]
    sp = distributed.make_distributed(gen, dist)
    prob = convex.make_problem(gen, ms)
    sync_state = distributed.SyncState(
        torch.zeros(sp.d, device="cuda", dtype=sp.A.dtype),
        torch.zeros(sp.p, sp.ns, device="cuda", dtype=sp.A.dtype),
        torch.zeros(sp.d, device="cuda", dtype=sp.A.dtype))
    vr_state = centralvr.VRState(
        torch.zeros(prob.d, device="cuda", dtype=prob.A.dtype),
        torch.zeros(prob.n, device="cuda", dtype=prob.A.dtype),
        torch.zeros(prob.d, device="cuda", dtype=prob.A.dtype))
    perms = distributed.draw_sync_orders(gen, sp.p, sp.ns, 1)[1][0]
    order = centralvr.draw_orders(gen, prob.n, 1)[1][0]
    eta = 1e-3
    runs = {
        "centralvr_sync p=8 (8, 1000)": lambda k: distributed.sync_round(
            sp, sync_state, eta, perms[:, :k],
            fused=fusedmod.make_params(True, eta, sp.lam, "cuda")),
        "centralvr millionsong (1, 90)": lambda k: centralvr.epoch(
            prob, vr_state, eta, order[:k],
            fused=fusedmod.make_params(True, eta, prob.lam, "cuda")),
    }
    for label, run in runs.items():
        run(50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        # device-side rows only (kernels, copies): an operator's row
        # repeats the device time of the kernels it launched
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        device_us = sum(r[0] for r in rows) / steps
        log(f"[profile] {label}: {wall_us:.2f} us/step untraced, device "
            f"{device_us:.2f} us/step, busy share "
            f"{device_us / wall_us:.3f}, device ops "
            f"{sum(r[1] for r in rows) / steps:.2f}/step")
        for t, count, key in rows[:8]:
            log(f"[profile]   {t / steps:8.3f} us/step  {count / steps:5.2f}"
                f"/step  {key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels.vr_update import kernel as vr_kernel
    from repro_torch.kernels.vr_update import ref as vr_ref
    from repro_torch.prox import operators as proxops

    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build(vr_kernel)
    worst = phase_compare(torch, np, vr_kernel, vr_ref, proxops)
    paths = phase_main_path(torch, vr_kernel)
    launches = sum(p["launches"] for p in paths)
    sync_shape = time_vr_update(torch, np, vr_kernel, vr_ref, (8, 1000))
    cvr_shape = time_vr_update(torch, np, vr_kernel, vr_ref, (1, 90))
    if "--profile" in sys.argv[1:]:
        phase_profile(torch)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(f"[card] {smi}")
    log(json.dumps({"kernels": [{
        "name": "vr_update", "route": "cuda",
        "source": "src/repro_torch/kernels/vr_update/csrc/vr_update.cu",
        "replaces": "src/repro/kernels/vr_update/kernel.py:64",
        "launches": launches, "max_abs_err": worst["float64"],
        "ms": sync_shape["ms"], "plain_ms": sync_shape["plain_ms"],
        "bound_ms": sync_shape["bound_ms"],
        "bound_by": sync_shape["bound_by"], "library_ms": None,
        "shape": sync_shape["shape"], "dtype": "float64",
        "eager_ms": sync_shape["eager_ms"],
        "other_shapes": [cvr_shape],
        "paths": [{k: p[k] for k in ("label", "launches", "steps", "wall_s",
                                     "unfused_wall_s", "peak_bytes")}
                  for p in paths]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
