#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA Hopper
card, from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which raises on failure:

  1. device: name, compute capability (must be 9.0), name and power limit
     as nvidia-smi reports them;
  2. build: compiles the hand-written CUDA kernels ``vr_update`` (K1),
     ``vr_epoch`` (K1's epoch route for the convex paths), ``lazy_epoch``
     (the sparse driver's epoch), ``rmsnorm``
     (K2), ``flash_attention`` (K3) and ``ssd_scan`` (K4) from the
     checkout's sources, one nvcc each, all started together
     (sm_90a), timed; prints each kernel's ptxas registers and spills, the
     number of HGMMA (wgmma) instructions in K3's SASS and of HMMA
     (mma.sync) instructions in K4's (``cuobjdump -sass``; each must be
     above 0);
  3. each kernel against its plain PyTorch version on the card. K1 at the
     convex paths' former shapes (8, 1000) and (1, 90), float64 and
     float32, and
     (1, 1000) and (1, 20) (the single-worker events of Algorithms 3 and
     5, the Fig. 1 panel) in float64, SAGA off and on, decay 0 and 2e-4,
     prox none / l1 / elasticnet / box: largest absolute error <= 1e-12 in float64, <= 1e-6 of the
     largest magnitude in float32; and at the LM steps' shapes, (1,
     1,556,113,920) and (2, N of ``qwen2-7b.reduced()``) float32 as the
     centralvr step launches it, x' and gtilde' within 1e-6 of their
     largest magnitude. K2 at 1024 x 3584 (the LM step's rows
     and width) in bfloat16 and float32, a ragged row count and the
     reduced width: error <= 1e-5 relative in float32, <= 1e-2 in
     bfloat16 (one rounding of a value below 4). K3 at the LM step's
     shape (S 1024, 28 query / 4 kv heads, hd 128), with a sliding
     window, S not a multiple of the block, H = KV, and the reduced
     config's shape: error <= 2e-2 (bf16 output, float32 sums in
     another order); and K3 in float32 at the LM step's shape and in
     bfloat16 at hd 256 (recurrentgemma-2b's 10 / 1 heads): <= 1e-4 in
     float32, 2e-2 in bf16. K1's bfloat16 lane (bf16 state, float32 g,
     g_old bf16 or float32) at (2, 2**20): <= one bf16 ulp of the largest
     magnitude. K4 (3xTF32 on the tensor cores) at Mamba2-130M's training
     shape (B 4, S 2048, 24 heads, P 64, N 128, chunk 64), at S 2000, at
     the reduced config's shape (P 16, N 16, chunk 8) and at the training
     shape with fast-decaying heads (dt >= 4, exp(L) underflows): <= 1e-4
     absolute and relative, the reference's kernel tolerance. vr_epoch,
     one epoch against its plain version (a loop of K1's, T cut to 5000
     where longer), every output within 1e-10 of its largest magnitude:
     at the paths' shapes with their lanes ((8, 1000) T 5000 centralvr;
     (1, 90) ridge; (1, 20) centralvr, saga and svrg with repeated
     indices; (1, 1000) centralvr and, T 100, saga; (8, 1000) svrg),
     every lane x loss x prox at (2, 90) with repeated indices, and per
     lane odd d 999, dense repeats (n 5) and d 20000 (state above the
     on-chip capacity); A off 16-byte alignment and d at the on-chip
     capacity (4096, 8 coordinates a thread);
  4. convex main path, float64, through ``repro_torch.solve`` with
     fused=True:
     CentralVR-Sync (Algorithm 2) at p=8 on the paper's §6.2
     ``dist-toy-logistic`` (n=5000 per worker, d=1000) and CentralVR
     (Algorithm 1) on ``millionsong`` (n=46371, d=90), 10 rounds each.
     vr_epoch must launch exactly once per fused epoch call (the init
     epoch and each round: 11) and K1 never; the trajectory must match
     the unfused run with the same visit orders to 1e-9; every rel must
     be finite and the last below the first;
  5. the rest of the convex family through ``repro_torch.solve``, each
     VR run fused and then unfused on the same draws: the paper's Fig. 1
     panel on ``toy-logistic`` (n 5000, d 20; CentralVR, SVRG with
     snapshot last, SAGA, SGD; 10 epochs) and §6.2's
     ``dist-toy-logistic`` at p=8 (CentralVR-Async round-robin, 2 rounds;
     D-SVRG, tau 2*ns, 3 rounds; D-SAGA with instant and with stale
     fetch, tau 100, 20 rounds; distributed SGD, EASGD and PS-SVRG, 2
     rounds each). vr_epoch must launch exactly once per fused epoch
     call (CentralVR epochs + 1, SVRG and SAGA epochs, CentralVR-Async
     1 + rounds * p, D-SVRG rounds with the 8 workers in one launch,
     D-SAGA rounds * p), K1 never, and nothing for an unfused run or SGD,
     distributed SGD, EASGD or PS-SVRG;
     fused and unfused within 1e-9; every rel finite, the last below the
     first for each VR algorithm. Prints each run's rels, gradient
     evaluations per round, inner steps/s and launches;
  4c. the spmd backend (``core/spmd.py``, ``launch/mesh.py``): the ranks
     are processes started by ``launch.mesh.spawn_workers`` (the kernels
     built here first), each running its worker on the card through the
     same entry points with ``backend="spmd"``, against the vmap run
     here on the same draws. §6.2's ``dist-toy-logistic`` over 8 ranks
     with the transport "auto" picks (gloo on one card, staged through
     host memory; NCCL refuses two ranks on one device), every VR run
     fused: CentralVR-Sync (10 rounds), CentralVR-Async round-robin and
     with speeds 1..8 (2 rounds), D-SVRG (tau 2*ns, 3 rounds), stale
     D-SAGA (tau 100, 20 rounds), distributed SGD, EASGD and PS-SVRG (2
     rounds each); CentralVR-Sync over NCCL at world = the card count
     (1 here, so p = 1) and Algorithm 1 on ``millionsong`` in a group of
     one rank; Mamba2-130M at full width and depth, W = 2, fused, over 2
     ranks sharing the card, 2 epochs from the seed of the vmap W = 2 run
     made here first. Gates: every rank on the card; each rank launched
     vr_epoch exactly once per fused epoch call of its own worker (the
     init epoch and each round, each event it owns) and nothing else,
     the LM ranks a W = 1 step's launches; x and rels bit-identical
     across ranks and within 1e-9 of the vmap run's (relative), finite,
     the last below the first for the VR algorithms; the LM's losses and
     2**20 sampled params within ``LM_TOL`` (rtol 3e-5, atol 1e-6) of
     the vmap run's. ``[spmd]`` lines give the transport, world, the
     ranks' devices, walls and inner steps/s beside the vmap run's and
     the bytes each rank's collectives carried, for the record: on one
     card they measure time-slicing and host staging, not scaling;
  5b. the sparse lazy driver (``sampling="sparse"``): (a) ``lazy_epoch``
     against its plain version, one epoch per case, every output within
     1e-10 of its largest magnitude: vr on and off x logistic and ridge
     x prox none and l1 at (n 48, d 40, width 3), width 1, widths 300
     and 1024 (more entries than a block's threads), zero absorbing,
     drifts of ~1e-300 and ~1e-12 (a step count above 2**31), the
     README's shape (n 4096, d 16384, width 32), rows of varying length
     at the stand-in's n and d (value-0 padding up to the longest row,
     1024; the epoch's first 2000 steps), consecutive rows that share
     most coordinates (d = 2 x width) and rows visited twice in a row
     (``kernels/lazy_epoch/cases.py``); (b) the README's sparse
     example through ``solve`` (20 rounds, ``l1:0.001``, whose answer is
     x = 0 at this scale, and ``l1:1e-6``) against the dense fused route
     on the same draws: x within 1e-10, rels within 1e-10 relative,
     lazy_epoch launched rounds + 1 times and nothing else, vr_epoch
     rounds + 1 on the dense run; (c) the same on a uniform-74 stand-in
     for LIBSVM's rcv1.binary: its n 20,242 and d 47,236, and exactly 74
     nonzeros in every row, its mean (the real rows' lengths vary, and
     the longest set the kernel's width), drawn, 3 rounds, ``l1:1e-5``
     and ``l1:1e-7``; and ``[time]`` lines: lazy_epoch per epoch and per
     step at both shapes and on rows of varying length at the stand-in's
     n and d (a log-normal law of lengths, mean 74 before the cut at
     1024) beside its bound (the visited rows' nonzero entries) and the
     bytes its steps touch, its plain version's time, its phase split
     (the timing probes that end every step after the look-ahead's
     copies, its membership (the state load), its catch-up and the
     reduction, and the passes over d alone) and its
     serial floor (the probe ``lazy_epoch_floor``) with which of bound
     and floor sets the pace, and the dense route's vr_epoch per step
     on the stand-in; then
     one fused Algorithm 1 run with ``track_iterates`` (toy-logistic, 2
     epochs, 3 vr_epoch launches) against the unfused one at 1e-9;
  6. LM main path: CentralVR training of the Qwen2-7B-width model cut to
     2 layers (1,556,113,920 parameters, float32 masters, bfloat16
     compute) through ``train.step.make_epoch_runner(fused=True)`` at
     W=1, M=2, seq 1024, global batch 2, microbatch 1, remat "block": 2
     epochs (4 steps), then the same run unfused from the same seed, one
     after the other (the two states do not fit together). Every loss
     must be finite; fused and unfused losses must agree to 2**-7
     relative (two bf16 ulps), and the params' updates over the run, on
     2**20 sampled coordinates, to 5% in norm. Launches per step must be
     exactly K1 1, K2 (2L + 1 + 2L) * A = 18, K3 (L + L) * A = 8 (the
     recompute under remat relaunches K2 and K3). Each run then trains
     10 more epochs, each timed, for its steps/s (median, least, most).
     Then W=2 at ``qwen2-7b.reduced()``, fused against unfused, held the
     same way. Then Mamba2-130M at its full published width and depth (24
     SSD blocks, d 768, state 128, vocab 50280, tied head; 128,983,488
     parameters) at W=2, M=2, seq 2048, global batch 16, microbatch 4
     (A = 2), the same gates, with launches per step K1 1, K2
     (L + 1 + L) * A * W = 196, K4 (L + L) * A * W = 192; and W=2 at
     ``mamba2-130m.reduced()``;
  7. the ``kernels`` line: per kernel its launches on the main paths, its
     device time per launch and its plain version's (CUDA-graph replay of
     back-to-back calls at the main path's shape; CUDA events for K1 at
     the LM shapes and for vr_epoch), its bound on this card, the time of
     the one PyTorch call that computes the same function where there is
     one (``F.rms_norm``, ``F.scaled_dot_product_attention``; timed as a
     yardstick only; none for K1, vr_epoch, lazy_epoch and K4; K2 and
     ``F.rms_norm`` with a cold L2: inputs taken in turn from enough
     buffers, and every output kept, that each call reads and writes
     device memory) and its
     largest error
     against the plain version; K1 at the LM step's (1, 1,556,113,920)
     float32, also at the reduced shape and Mamba2-130M's (2,
     128,983,488), K2 also at 8192 x 768 and K3 also in float32 and at
     hd 256 (``other_shapes``); K1's ``paths`` the LM runs. vr_epoch per epoch and per step at each convex path's shape
     (``EPOCH_SHAPES``), its plain version's time over the whole epoch
     (and per step), its bound
     (bytes per epoch) beside its serial floor (the probe
     ``vr_epoch_floor``: barrier, shuffle tree and one exp a step) and
     which of the two sets the pace; its ``paths`` give each convex
     run's launches, inner steps/s and gradient evaluations per round.
     K3's ``[time]``
     lines give its TFLOP/s and share of the bound beside SDPA's. K4's
     give its bound on the tensor cores (bytes; the TF32 operations bound
     and the 3xTF32 floor beside it, and the float32 figure of its first
     port, 67 TFLOP/s outside the tensor cores), its share of the bound,
     its launches per call (one: the state passes between chunks inside
     the launch) and the fused Mamba2-130M run's peak memory.

With ``--profile`` it then traces every fused VR run of phases 4 and 5
through ``solve`` and one fused epoch of each full-width LM (Qwen2
width, Mamba2-130M, and Mamba2-130M unfused) with ``torch.profiler`` and
prints the device time, the device busy share against the same run
untraced, the kernels that take the device time, and the LM backward's
device time by autograd node.

``--sparse`` runs only the device phase, the build and phase 5b;
``--spmd`` only the device phase, the build and phase 4c.

``--rates`` runs only the device phase, vr_epoch's device time at each
convex path's shape, lazy_epoch's per epoch through its public wrapper
on phase 5b's three timed problems (the README shape, the uniform-74
stand-in, the rows of varying length; drawn from this checkout's case
module), and every fused VR run of phases 4 and 5 through
``solve`` (after one small solve that builds the kernel), printing each
run's inner steps/s; ``--src DIR`` imports the
port from another checkout's ``src`` instead, so that two checkouts are
timed in one call on one card (``python3 chip_smoke.py --rates --src
parent/src; python3 chip_smoke.py --rates``).

TF32 is off for matrix products and convolutions, so float32 products
are full float32 (the convex path runs in float64, the LM in bfloat16).

Without a CUDA device it exits with status 1 and prints no result. The
last line of its output is ``{"ok": true, "device": {...}}``.
"""
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _src_dir():
    """The port's ``src`` directory: the checkout's own, or ``--src DIR``
    (another checkout's, for ``--rates``)."""
    args = sys.argv[1:]
    if "--src" in args:
        return Path(args[args.index("--src") + 1]).resolve()
    return ROOT / "src"


sys.path.insert(0, str(_src_dir()))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor-core FLOP/s
# by type, and dense bf16 and TF32 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bf16_tensor": 989e12,
              "tf32_tensor": 495e12}
# operations per element of the main path's launch (saga off, no prox):
# v = g - g_old + gbar (2), x*scale - eta*v (3), gtilde + g*inv_m (2)
VR_OPS_PER_ELEMENT = 7
# arrays of the (p, d) batch the main path's launch moves once each: reads
# x, g, g_old, gbar, gtilde; writes x', gtilde' (gbar' only with SAGA, and
# table' is g itself)
VR_STREAMS = 7
ROUNDS = 10
# RMSNorm: x*x, the sum, *r, *scale per element (float32 arithmetic)
RMS_OPS_PER_ELEMENT = 4
L2_BYTES = 50 * 2**20           # H100 L2
LM_EPOCHS = 2
LM_TIMING_EPOCHS = 10           # more epochs after the agreement check, timed
LM_SAMPLES = 1 << 20            # sampled param coordinates for agreement
LOSS_RTOL = 2.0 ** -7           # two bf16 ulps
UPDATE_RTOL = 0.05
SSD_TOL = 1e-4                  # the reference's kernel tolerance
EPOCH_TOL = 1e-10               # vr_epoch: of the output's largest magnitude
EPOCH_PLAIN_STEPS = 5000        # phase 3: T of the plain host loop cut to this


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


def phase_build(kernels):
    """Build every kernel, one nvcc each, all started together."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build(*(k.SOURCE for k in kernels.values()))
    for k in kernels.values():
        k._load()
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(lib.name for lib in libs)} in {dt:.2f} s")
    for name, out in build.logs.items():
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line or ("ptxas" in line and "Used" in line):
                log(f"[build]   {name}: {entry[-60:]}: {line.strip()}")
    # tensor-core instructions in the SASS: K3's wgmma, K4's mma.sync
    for name, op, what in (("flash_attention", "HGMMA", "the bf16 path does "
                            "not issue wgmma"),
                           ("ssd_scan", "HMMA", "the scan's products are "
                            "not on the tensor cores")):
        lib = libs[list(kernels).index(name)]
        sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"),
                               "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        count = sum(op in line for line in sass.splitlines())
        log(f"[build] {lib.name}: {count} {op} instructions in its SASS "
            f"(cuobjdump -sass)")
        if not count:
            raise AssertionError(f"{name}'s SASS has no {op}: {what}")
    return dt


def reset_counts(kernels):
    for k in kernels.values():
        k.reset_launches()


def read_counts(kernels):
    return {name: k.launches for name, k in kernels.items()}


def phase_compare(torch, np, vr_kernel, vr_ref, proxops):
    worst = {"float64": 0.0, "float32": 0.0}
    cases = 0
    for shape, dtypes in (((8, 1000), (torch.float64, torch.float32)),
                          ((1, 90), (torch.float64, torch.float32)),
                          ((1, 1000), (torch.float64,)),
                          ((1, 20), (torch.float64,))):
        for dtype in dtypes:
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


def phase_compare_rmsnorm(torch, rms_kernel, rms_ref):
    """K2 against its plain version; returns the largest bf16 error at the
    two main-path shapes."""
    worst_at = {(1024, 3584): 0.0, (8192, 768): 0.0}
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows, d, dt, sdt, off in (
            (1024, 3584, torch.bfloat16, torch.bfloat16, 0),
            (1024, 3584, torch.float32, torch.float32, 0),
            (8192, 768, torch.bfloat16, torch.bfloat16, 0),
            (37, 3584, torch.bfloat16, torch.float32, 0),
            (512, 128, torch.bfloat16, torch.bfloat16, 0),
            (64, 1001, torch.bfloat16, torch.bfloat16, 0),
            (16, 1024, torch.bfloat16, torch.bfloat16, 1)):
        # off: x starts one element into its buffer (not 16-byte aligned)
        x = torch.randn(rows * d + off, generator=g, device="cuda").to(
            dt)[off:].view(rows, d)
        s = torch.randn(d, generator=g, device="cuda").to(sdt)
        y = rms_kernel.rmsnorm(x, s)
        torch.cuda.synchronize()
        want = rms_ref.rmsnorm_ref(x, s).float()
        err = (y.float() - want).abs().max().item()
        tol = (1e-5 if dt == torch.float32 else 1e-2) * max(
            1.0, want.abs().max().item())
        plan = rms_kernel.vector_plan(d, x.element_size(), x.data_ptr(),
                                      s.data_ptr(), y.data_ptr())
        log(f"[compare] rmsnorm ({rows}, {d}) {dt} scale {sdt} offset {off} "
            f"plan {plan}: max abs err {err!r} (tolerance {tol!r})")
        if not err <= tol:
            raise AssertionError(f"rmsnorm ({rows}, {d}) {dt}: {err} > {tol}")
        if dt == torch.bfloat16 and (rows, d) in worst_at:
            worst_at[(rows, d)] = max(worst_at[(rows, d)], err)
    return worst_at


def phase_compare_flash(torch, fa_kernel, fa_ref):
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(1)
    for B, S, H, KV, hd, win in ((1, 1024, 28, 4, 128, None),
                                 (1, 1024, 28, 4, 128, 200),
                                 (2, 200, 4, 2, 32, None),
                                 (1, 256, 4, 4, 64, None),
                                 (1, 1024, 4, 2, 32, None),
                                 (1, 100, 4, 2, 32, 16),
                                 (2, 200, 28, 4, 128, None),
                                 (2, 200, 28, 4, 64, None),
                                 (1, 2048, 28, 4, 128, None),
                                 (1, 2048, 28, 4, 128, 200)):
        q, k, v = (torch.randn(B, S, n, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for n in (H, KV, KV))
        out = fa_kernel.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        err = (out.float() - fa_ref.flash_attention_ref(
            q, k, v, window=win).float()).abs().max().item()
        log(f"[compare] flash_attention B={B} S={S} H={H} KV={KV} hd={hd} "
            f"window={win}: max abs err {err!r} (tolerance 0.02)")
        if not err <= 2e-2:
            raise AssertionError(f"flash_attention S={S} H={H} KV={KV} "
                                 f"hd={hd} window={win}: {err} > 0.02")
        if (S, H, hd, win) == (1024, 28, 128, None):
            worst = err
    return worst


def phase_compare_flash_repaired(torch, fa_kernel, fa_ref):
    """K3 in float32 at the Qwen2 slice's shape and in bfloat16 at hd 256;
    returns the largest error of each."""
    worst = {}
    g = torch.Generator(device="cuda").manual_seed(4)
    for B, S, H, KV, hd, win, dt, tol in (
            (1, 1024, 28, 4, 128, None, torch.float32, 1e-4),
            (1, 300, 4, 1, 256, 64, torch.float32, 1e-4),
            (1, 1024, 10, 1, 256, None, torch.bfloat16, 2e-2),
            (1, 200, 4, 2, 256, 16, torch.bfloat16, 2e-2)):
        q, k, v = (torch.randn(B, S, n, hd, generator=g, device="cuda")
                   .to(dt) for n in (H, KV, KV))
        out = fa_kernel.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        want = fa_ref.flash_attention_ref(q, k, v, window=win).float()
        diff = (out.float() - want).abs()
        err = diff.max().item()
        excess = (diff - tol * (1.0 + want.abs())).max().item()
        key = str(dt).split(".")[-1]
        log(f"[compare] flash_attention {key} B={B} S={S} H={H} KV={KV} "
            f"hd={hd} window={win}: max abs err {err!r} (tolerance {tol} "
            f"abs and relative)")
        if not excess <= 0:
            raise AssertionError(f"flash_attention {key} hd={hd} S={S}: "
                                 f"error above {tol} abs + rel by {excess}")
        if win is None:
            worst[f"{key}_hd{hd}"] = err
    return worst


def phase_compare_vr_bf16(torch, vr_kernel, vr_ref):
    """K1's bfloat16 lane: bf16 state, float32 g, g_old bf16 (a table row)
    or float32 (SVRG's snapshot gradient), SAGA off and on."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(5)
    shape = (2, 1 << 20)
    for old_dt in (torch.bfloat16, torch.float32):
        for saga in (False, True):
            x, gbar, gtilde = (torch.randn(shape, generator=g, device="cuda")
                               .to(torch.bfloat16) for _ in range(3))
            gf = torch.randn(shape, generator=g, device="cuda")
            g_old = torch.randn(shape, generator=g, device="cuda").to(old_dt)
            kw = dict(eta=0.1, m=2, saga=saga)
            got = vr_kernel.vr_update(x, gf, g_old, gbar, gtilde, **kw)
            torch.cuda.synchronize()
            want = vr_ref.vr_update_ref(x, gf, g_old, gbar, gtilde, **kw)
            for w, h in zip(want, got):
                err = (h.float() - w.float()).abs().max().item()
                bound = 2.0 ** -8 * w.float().abs().max().item()
                if not err <= bound:
                    raise AssertionError(f"vr_update bf16 lane g_old "
                                         f"{old_dt} saga={saga}: {err} > "
                                         f"{bound}")
                worst = max(worst, err)
    log(f"[compare] vr_update bf16 lane {list(shape)} (g_old bf16 / f32, "
        f"saga off / on): max abs err {worst!r} (tolerance one bf16 ulp of "
        f"the largest magnitude)")
    return worst


def ssd_inputs(torch, B, S, H, P, N, seed, dt_min=0.0):
    """Inputs of the scan as the block makes them: x, dt = softplus(.),
    A_log = log(1..H), B and C; dt_min > 0 shifts dt up (fast-decaying
    heads)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g, device="cuda")
    dt = dt_min + torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=g, device="cuda"))
    A_log = torch.arange(1, H + 1, device="cuda", dtype=torch.float32).log()
    Bc = torch.randn(B, S, N, generator=g, device="cuda")
    Cc = torch.randn(B, S, N, generator=g, device="cuda")
    return x, dt, A_log, Bc, Cc


def ssd_plain(torch, ssd_ref, x, dt, A_log, Bc, Cc, chunk):
    """K4's flat plain version on the model-layout inputs."""
    B, S, H, P = x.shape
    la = -torch.exp(A_log)[None, None, :] * dt
    y = ssd_ref.ssd_scan_ref(
        la.transpose(1, 2).reshape(B * H, S),
        (x * dt[..., None]).transpose(1, 2).reshape(B * H, S, P), Bc, Cc,
        chunk=chunk)
    return y.reshape(B, H, S, P).transpose(1, 2)


def phase_compare_ssd(torch, ssd_kernel, ssd_ref):
    """K4 (the model-layout entry the block calls) against its plain
    version: at Mamba2-130M's training shape, at a ragged S, at the
    reduced config's shape, and at the training shape with fast-decaying
    heads (dt >= 4); returns the largest error at the first."""
    worst = None
    for i, (B, S, H, P, N, Q, dt_min) in enumerate((
            (4, 2048, 24, 64, 128, 64, 0.0), (4, 2000, 24, 64, 128, 64, 0.0),
            (4, 256, 16, 16, 16, 8, 0.0), (4, 2048, 24, 64, 128, 64, 4.0))):
        ins = ssd_inputs(torch, B, S, H, P, N, seed=10 + i, dt_min=dt_min)
        y = ssd_kernel.ssd_scan(*ins, chunk=Q)
        torch.cuda.synchronize()
        want = ssd_plain(torch, ssd_ref, *ins, Q)
        err = (y - want).abs()
        excess = (err - SSD_TOL * (1.0 + want.abs())).max().item()
        log(f"[compare] ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={Q} "
            f"dt_min={dt_min}: max abs err {err.max().item()!r}, largest "
            f"|y| {want.abs().max().item()!r} (tolerance {SSD_TOL} abs and "
            f"relative)")
        if not excess <= 0:
            raise AssertionError(f"ssd_scan S={S} P={P} N={N}: error above "
                                 f"{SSD_TOL} abs + rel by {excess}")
        if worst is None:
            worst = err.max().item()
    return worst


def epoch_inputs(torch, p, n, d, T, *, repeats=False, kind="logistic",
                 seed=0, offset=0):
    """Inputs of a vr_epoch call on the card, from a seeded generator:
    A (p, n, d) with rows of norm ~1 (``offset``: A starts that many
    float64 elements into its buffer), labels (+-1 for logistic), visit
    orders (permutations cut to T, or with ``repeats`` uniform draws that
    repeat indices), x, table, gbar."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    f64 = dict(device="cuda", dtype=torch.float64)
    A = (torch.randn(p * n * d + offset, generator=g, **f64)
         / d ** 0.5)[offset:].view(p, n, d)
    b = (torch.randint(0, 2, (p, n), generator=g, device="cuda") * 2.0 - 1.0
         if kind == "logistic" else torch.randn(p, n, generator=g, **f64))
    if repeats:
        orders = torch.randint(0, n, (p, T), generator=g, device="cuda")
    else:
        orders = torch.stack([torch.randperm(n, generator=g, device="cuda")
                              for _ in range(p)])[:, :T].contiguous()
    x = 0.1 * torch.randn(p, d, generator=g, **f64)
    table = 0.3 * torch.randn(p, n, generator=g, **f64)
    gbar = 0.01 * torch.randn(p, d, generator=g, **f64)
    return A, b.to(torch.float64), orders, x, table, gbar


def epoch_cases():
    """Phase 3's vr_epoch cases: (label, (p, n, d, T), repeats, lane, kind,
    prox, A's offset). The paths' shapes, each with its lane, T cut to
    EPOCH_PLAIN_STEPS where longer; every lane x loss x prox at (2, 400,
    90) with repeated indices; per lane an odd d, dense repeats (n 5:
    indices recur 1 and 2 steps apart) and a d above the on-chip capacity
    (state and rows in global memory); A off 16-byte alignment and d at
    the on-chip capacity (4096: 512 threads of 8 coordinates)."""
    cut = EPOCH_PLAIN_STEPS
    lanes = ("centralvr", "saga", "svrg")
    cases = [
        ("Alg 2 round", (8, 5000, 1000, 5000), False, "centralvr",
         "logistic", None, 0),
        ("Alg 1 millionsong", (1, 46371, 90, cut), False, "centralvr",
         "ridge", None, 0),
        ("Fig. 1 centralvr", (1, 5000, 20, 5000), False, "centralvr",
         "logistic", None, 0),
        ("Fig. 1 saga", (1, 5000, 20, 5000), True, "saga", "logistic", None,
         0),
        ("Fig. 1 svrg", (1, 5000, 20, 5000), True, "svrg", "logistic", None,
         0),
        ("Alg 3 event", (1, 5000, 1000, cut), False, "centralvr",
         "logistic", None, 0),
        ("Alg 4 round", (8, 5000, 1000, cut), True, "svrg", "logistic",
         None, 0),
        ("Alg 5 event", (1, 5000, 1000, 100), True, "saga", "logistic",
         None, 0),
    ]
    for lane in lanes:
        for kind in ("logistic", "ridge", "huber@0.5", "pseudo_huber"):
            for prox in (None, "l1:0.05", "elasticnet:0.05:0.3",
                         "box:-0.2:0.3"):
                cases.append(("grid", (2, 400, 90, 300), True, lane, kind,
                              prox, 0))
    for lane in lanes:
        cases += [("odd d", (2, 300, 999, 300), True, lane, "logistic",
                   "l1:0.001", 0),
                  ("dense repeats", (1, 5, 20, 400), True, lane, "logistic",
                   None, 0),
                  ("d above capacity", (1, 64, 20000, 100), True, lane,
                   "logistic", None, 0)]
    cases += [("misaligned A", (2, 300, 1000, 300), True, "centralvr",
               "logistic", None, 1),
              ("on-chip capacity", (1, 100, 4096, 100), True, "saga",
               "logistic", None, 0)]
    return cases


def phase_compare_epoch(torch, vr_epoch, vr_ref, proxops):
    """vr_epoch against its plain version on the card, one epoch per case
    (``epoch_cases``): every output within EPOCH_TOL of its largest
    magnitude. Returns the largest absolute and relative errors."""
    worst_abs = worst_rel = 0.0
    t0 = time.perf_counter()
    for k, (label, (p, n, d, T), repeats, lane, kind, prox,
            offset) in enumerate(epoch_cases()):
        ins = epoch_inputs(torch, p, n, d, T, repeats=repeats, kind=kind,
                           seed=30 + k, offset=offset)
        kw = dict(lane=lane, kind=kind, eta=0.05, decay=2e-4, m=n * p,
                  prox=proxops.parse(prox) if prox else None)
        have = vr_epoch.vr_epoch(*ins, **kw)
        torch.cuda.synchronize()
        want = vr_ref.vr_epoch_ref(*ins, **kw)
        errs = []
        for name, h, w in zip(("x", "table", "gbar", "acc"), have, want):
            if w is None:
                continue
            err = (h - w).abs().max().item()
            scale = w.abs().max().item()
            if not (bool(torch.isfinite(h).all())
                    and err <= EPOCH_TOL * scale):
                raise AssertionError(
                    f"vr_epoch {label} {lane} {kind} {prox} ({p}, {n}, {d})"
                    f" T {T}: {name} max abs err {err} > {EPOCH_TOL} of "
                    f"{scale}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale if scale else 0.0)
            errs.append(f"{name} {err:.3e}")
        if label != "grid":
            plan = vr_epoch.launch_plan(p, d)
            log(f"[compare] vr_epoch {label} {lane} {kind} prox {prox} "
                f"(p {p}, n {n}, d {d}, T {T}, repeats {repeats}): "
                f"{plan.threads} threads of {plan.coords} coordinates; max "
                f"abs err {', '.join(errs)}")
    log(f"[compare] vr_epoch vs plain version: {len(epoch_cases())} cases "
        f"in {time.perf_counter() - t0:.1f} s, max abs err {worst_abs!r}, "
        f"largest error over its output's largest magnitude {worst_rel!r} "
        f"(tolerance {EPOCH_TOL})")
    return worst_abs, worst_rel


def drive(torch, solve, spec_kw, cfg, orders, kernels, label, *, launches,
          inner_steps, evals, vr=True):
    """One main-path run through ``solve`` on the given draws: the fused
    run and, for a VR algorithm, its unfused twin on the same draws (the
    other algorithms have no fused form). Gates: vr_epoch launched exactly
    ``launches`` times (one per fused epoch or inner loop), K1 and every
    other kernel never, the unfused twin launched nothing, fused and
    unfused within 1e-9, every rel finite, for a VR algorithm the last
    below the first, and the run on the card. ``inner_steps`` counts the
    run's inner steps (init epoch included; workers stepping together
    count once) and ``evals`` its gradient evaluations per round (Table
    1). Returns the run's record."""
    import numpy as np

    from repro_torch import RunSpec

    rounds = spec_kw["rounds"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    first = solve(RunSpec(fused=True, **spec_kw) if vr
                  else RunSpec(**spec_kw), cfg, orders=orders)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(kernels, 0)
    want["vr_epoch"] = launches
    if counts != want or first.launches != {"vr_update": 0,
                                            "vr_epoch": launches,
                                            "lazy_epoch": 0}:
        raise AssertionError(f"{label}: launched {counts} (solve counted "
                             f"{first.launches}), expected {want}: one "
                             f"vr_epoch per fused epoch call, nothing else")
    if first.device != torch.cuda.get_device_name(0):
        raise AssertionError(f"{label}: ran on {first.device}")
    rels = first.rels
    log(f"[path] {label}: rels {[float(r) for r in rels]}")
    diff, wall_u = 0.0, None
    if vr:
        reset_counts(kernels)
        t1 = time.perf_counter()
        unfused = solve(RunSpec(fused=False, **spec_kw), cfg, orders=orders)
        torch.cuda.synchronize()
        wall_u = time.perf_counter() - t1
        if any(read_counts(kernels).values()):
            raise AssertionError(f"{label}: the unfused run launched "
                                 f"{read_counts(kernels)}")
        diff = max(float(abs(rels - unfused.rels).max()),
                   float(abs(first.x - unfused.x).max()))
        log(f"[path] {label}: unfused rels "
            f"{[float(r) for r in unfused.rels]}")
    rate = inner_steps / wall
    log(f"[path] {label}: {'fused ' if vr else ''}wall {wall:.3f} s "
        f"({rate:.1f} inner steps/s, {inner_steps} inner steps), "
        + (f"unfused wall {wall_u:.3f} s ({inner_steps / wall_u:.1f} inner "
           f"steps/s), " if vr else "")
        + f"vr_epoch launches {launches}, K1 launches {counts['vr_update']}"
        f", gradient evaluations per round {evals}, peak memory "
        f"{peak / 2**20:.1f} MiB, max |fused - unfused| {diff!r}, eta "
        f"{first.spec.eta!r}")
    if not (len(rels) == rounds and np.isfinite(rels).all()):
        raise AssertionError(f"{label}: rels not finite: {rels}")
    if vr and not rels[-1] < rels[0]:
        raise AssertionError(f"{label}: no progress, rels {rels}")
    if not diff <= 1e-9:
        raise AssertionError(f"{label}: fused and unfused differ by {diff}")
    return dict(label=label, launches=launches,
                k1_launches=counts["vr_update"], wall_s=wall,
                unfused_wall_s=wall_u, inner_steps=inner_steps,
                inner_steps_s=rate, evals_per_round=evals, peak_bytes=peak,
                rels=[float(r) for r in rels], max_diff=diff)


def main_runs(torch):
    """Phase 4's runs, with their draws: (label, spec, cfg, draws,
    vr_epoch launches, inner steps, gradient evaluations per round, VR
    algorithm). One vr_epoch launch for the init epoch and one per round
    or epoch."""
    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import centralvr, distributed

    gen = torch.Generator(device="cuda").manual_seed(0)
    dist, ms = PRESETS["dist-toy-logistic"], PRESETS["millionsong"]
    return [
        ("centralvr_sync p=8 dist-toy-logistic (5000x1000 per worker)",
         dict(algo="centralvr_sync", p=dist.workers, rounds=ROUNDS), dist,
         distributed.draw_sync_orders(gen, dist.workers, dist.n, ROUNDS),
         ROUNDS + 1, (ROUNDS + 1) * dist.n, dist.workers * dist.n, True),
        ("centralvr millionsong (46371x90)",
         dict(algo="centralvr", rounds=ROUNDS), ms,
         centralvr.draw_orders(gen, ms.n, ROUNDS), ROUNDS + 1,
         (ROUNDS + 1) * ms.n, ms.n, True),
    ]


def drive_all(torch, kernels, runs):
    from repro_torch import solve
    return [drive(torch, solve, spec, cfg, draws, kernels, label,
                  launches=launches, inner_steps=steps, evals=evals, vr=vr)
            for label, spec, cfg, draws, launches, steps, evals, vr in runs]


def phase_main_path(torch, kernels):
    return drive_all(torch, kernels, main_runs(torch))


def family_runs(torch):
    """Phase 5's runs, the rest of the convex family on the paper's
    settings: the Fig. 1 panel on ``toy-logistic`` (n 5000, d 20),
    CentralVR against SVRG (snapshot last), SAGA and SGD, 10 epochs each;
    and §6.2's ``dist-toy-logistic`` (p 8, 5000 x 1000 per worker):
    CentralVR-Async round-robin (2 rounds), D-SVRG (tau 2*ns, 3 rounds),
    D-SAGA with instant and stale fetch (tau 100, 20 rounds), distributed
    SGD, EASGD (tau 16) and PS-SVRG (2 rounds each). Every run's draws
    are made once and given to the fused run and its unfused twin."""
    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import baselines as bl
    from repro_torch.core import centralvr
    from repro_torch.core import distributed as ds

    gen = torch.Generator(device="cuda").manual_seed(1)
    toy, dist = PRESETS["toy-logistic"], PRESETS["dist-toy-logistic"]
    n, E = toy.n, ROUNDS
    p, ns = dist.workers, dist.n
    tau_dsvrg, tau_dsaga, tau_easgd = 2 * ns, 100, 16
    blocks = max(ns // tau_easgd, 1)
    # (label, spec, cfg, draws, vr_epoch launches (one per fused epoch
    #  call: the init epoch, each epoch or round, each event), inner steps,
    #  gradient evaluations per round, VR algorithm)
    runs = [
        ("centralvr toy-logistic (5000x20)",
         dict(algo="centralvr", rounds=E), toy,
         centralvr.draw_orders(gen, n, E), E + 1, (E + 1) * n, n, True),
        ("svrg toy-logistic (snapshot last)",
         dict(algo="svrg", rounds=E, snapshot="last"), toy,
         bl.draw_svrg_orders(gen, n, E, n), E, E * n, 3 * n, True),
        ("saga toy-logistic", dict(algo="saga", rounds=E), toy,
         bl.draw_saga_orders(gen, n, E), E, E * n, n, True),
        ("sgd toy-logistic", dict(algo="sgd", rounds=E), toy,
         bl.draw_sgd_orders(gen, n, E), 0, E * n, n, False),
        ("centralvr_async p=8 dist-toy-logistic (round-robin)",
         dict(algo="centralvr_async", p=p, rounds=2), dist,
         ds.draw_async_orders(gen, p, ns, 2), 1 + 2 * p, ns + 2 * p * ns,
         p * ns, True),
        ("dsvrg p=8 dist-toy-logistic (tau 2*ns)",
         dict(algo="dsvrg", p=p, rounds=3), dist,
         ds.draw_dsvrg_orders(gen, p, ns, 3, tau_dsvrg), 3, 3 * tau_dsvrg,
         p * ns + 2 * p * tau_dsvrg, True),
    ]
    for fetch in ("instant", "stale"):
        runs.append((
            f"dsaga p=8 dist-toy-logistic (fetch {fetch}, tau 100)",
            dict(algo="dsaga", p=p, rounds=20, tau=tau_dsaga, fetch=fetch),
            dist, ds.draw_dsaga_orders(gen, p, ns, 20, tau_dsaga), 20 * p,
            20 * p * tau_dsaga, p * tau_dsaga, True))
    runs += [
        ("dist_sgd p=8 dist-toy-logistic (tau ns)",
         dict(algo="dist_sgd", p=p, rounds=2), dist,
         bl.draw_dist_sgd_orders(gen, p, ns, 2, ns), 0, 2 * ns, p * ns,
         False),
        ("easgd p=8 dist-toy-logistic (tau 16)",
         dict(algo="easgd", p=p, rounds=2), dist,
         bl.draw_easgd_orders(gen, p, ns, 2, tau_easgd), 0,
         2 * blocks * tau_easgd, p * blocks * tau_easgd, False),
        ("ps_svrg p=8 dist-toy-logistic (2*ns steps)",
         dict(algo="ps_svrg", p=p, rounds=2), dist,
         bl.draw_ps_svrg_orders(gen, p, ns, 2), 0, 2 * 2 * ns,
         p * ns + 2 * p * 2 * ns, False),
    ]
    return runs


def phase_family(torch, kernels):
    t0 = time.perf_counter()
    out = drive_all(torch, kernels, family_runs(torch))
    log(f"[path] convex family: {len(out)} runs in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 5b: the sparse lazy driver on lazy_epoch
# ---------------------------------------------------------------------------

LAZY_TOL = 1e-10                # lazy_epoch: of the output's largest magnitude
SPARSE_ROUNDS = 20              # the README's sparse example
# a uniform stand-in for LIBSVM rcv1.binary: its n and d, and its mean
# nonzeros a row in every row
RCV1 = (20242, 47236, 74)
RCV1_ROUNDS = 3


def phase_compare_lazy(torch, lazy_kernel, lazy_ref):
    """lazy_epoch against its plain version on the card, one epoch per case
    (``kernels/lazy_epoch/cases.py``, the card tests' cases too): every
    output within LAZY_TOL of its largest magnitude. Returns the largest
    absolute and relative errors and the plain version's time over the
    README-shape epoch."""
    from repro_torch.kernels.lazy_epoch import cases

    worst_abs = worst_rel = 0.0
    plain_ms = None
    t0 = time.perf_counter()
    for case in cases.CASES:
        label, (n, d, w) = case.label, case.shape
        args, kw = cases.inputs(case, "cuda")
        have = lazy_kernel.lazy_epoch(*args, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = lazy_ref.lazy_epoch_ref(*args, **kw)
        torch.cuda.synchronize()
        if label == "README shape":
            plain_ms = (time.perf_counter() - t1) * 1e3
        errs = []
        for name, h, wt in zip(("z", "table", "acc"), have, want):
            err = (h - wt).abs().max().item()
            scale = wt.abs().max().item()
            if not (bool(torch.isfinite(h).all())
                    and err <= LAZY_TOL * scale):
                raise AssertionError(
                    f"lazy_epoch {label} ({n}, {d}, {w}): {name} max abs "
                    f"err {err} > {LAZY_TOL} of {scale}")
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / scale if scale else 0.0)
            errs.append(f"{name} {err:.3e}")
        zeros = int((have[0] == 0).sum())
        plan = lazy_kernel.launch_plan(w)
        log(f"[compare] lazy_epoch {label} (n {n}, d {d}, width {w}): "
            f"{plan.threads} threads of {plan.entries} entries; {zeros} "
            f"zeros in z; max abs err {', '.join(errs)}")
    log(f"[compare] lazy_epoch vs plain version: {len(cases.CASES)} cases "
        f"in {time.perf_counter() - t0:.1f} s, max abs err {worst_abs!r}, "
        f"largest error over its output's largest magnitude {worst_rel!r} "
        f"(tolerance {LAZY_TOL}); plain version over the README-shape "
        f"epoch {plain_ms!r} ms")
    return worst_abs, worst_rel, plain_ms


def sparse_pair(torch, kernels, label, prob, rounds, prox):
    """The sparse route and the dense fused route through ``solve`` on the
    same draws (the main path: every count set to 0 just before each run,
    read just after). Gates: lazy_epoch launched rounds + 1 times on the
    sparse run and nothing else; vr_epoch rounds + 1 on the dense run;
    final x within 1e-10 absolute and rels within 1e-10 relative; rels
    finite, and falling unless the answer is x = 0 from the start (then
    every rel is 0: an l1 weight above |grad f(0)|_inf, whose value is
    printed). Returns the record."""
    import numpy as np

    from repro_torch import RunSpec, solve
    from repro_torch.core import centralvr, convex

    gen = torch.Generator(device="cuda").manual_seed(5)
    orders = centralvr.draw_orders(gen, prob.n, rounds)
    runs, counts, walls = {}, {}, {}
    for route, kw in (("sparse", dict(sampling="sparse")),
                      ("dense", dict(fused=True))):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        runs[route] = solve(RunSpec("centralvr", rounds=rounds, prox=prox,
                                    **kw), prob, orders=orders)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        counts[route] = read_counts(kernels)
    for route, name in (("sparse", "lazy_epoch"), ("dense", "vr_epoch")):
        want = dict.fromkeys(kernels, 0)
        want[name] = rounds + 1
        solve_want = {k: want[k] for k in ("vr_update", "vr_epoch",
                                           "lazy_epoch")}
        if counts[route] != want or runs[route].launches != solve_want:
            raise AssertionError(
                f"{label} {route}: launched {counts[route]} (solve counted "
                f"{runs[route].launches}), expected {want}")
    sp, dn = runs["sparse"], runs["dense"]
    dx = float(np.abs(sp.x - dn.x).max())
    drel = float(max(abs(a - b) / abs(b) if b else abs(a)
                     for a, b in zip(sp.rels, dn.rels)))
    g0_inf = float(convex.full_grad(prob, torch.zeros_like(prob.A[0]))
                   .abs().max())
    log(f"[path] {label}: sparse rels {[float(r) for r in sp.rels]}")
    log(f"[path] {label}: dense fused rels {[float(r) for r in dn.rels]}")
    log(f"[path] {label}: sparse wall {walls['sparse']:.3f} s, dense fused "
        f"wall {walls['dense']:.3f} s; lazy_epoch launches "
        f"{counts['sparse']['lazy_epoch']}, vr_epoch "
        f"{counts['dense']['vr_epoch']}; max |x_sparse - x_dense| {dx!r}, "
        f"max relative rel difference {drel!r}; eta {sp.spec.eta!r}; "
        f"{int((sp.x == 0).sum())} of {sp.x.size} coordinates zero; "
        f"|grad f(0)|_inf {g0_inf!r}")
    trivial = not sp.rels.any() and not sp.x.any()
    if not (np.isfinite(sp.rels).all()
            and (trivial or sp.rels[-1] < sp.rels[0])):
        raise AssertionError(f"{label}: sparse rels {sp.rels}")
    if not (dx <= 1e-10 and drel <= 1e-10):
        raise AssertionError(f"{label}: sparse and dense differ: x {dx}, "
                             f"rels {drel} (relative)")
    return dict(label=label, prox=prox, zero_answer=trivial,
                grad0_inf=g0_inf, launches=counts["sparse"]["lazy_epoch"],
                dense_vr_epoch_launches=counts["dense"]["vr_epoch"],
                sparse_wall_s=walls["sparse"], dense_wall_s=walls["dense"],
                max_diff_x=dx, max_rel_diff_rels=drel,
                rels=[float(r) for r in sp.rels])


def lazy_bound(torch, val, perm, d):
    """The least time of one lazy epoch at the card's peak rates, from
    this run's inputs: each input read once and each output written once
    (the visited rows' nonzero entries, an int32 coordinate and a float64
    value each, and their labels; the orders; z, the table and gbar in; z,
    the table and acc out), against the card's bytes/s; operations (~30
    float64 a nonzero entry a visit: the catch-up's rounds, the dot, the
    update; ~10 a step) are far below. Padding entries (value 0) need
    nothing. Returns (bound ms, bytes or operations, bytes, the bytes the
    steps touch: every visit's nonzero entries' z, last, acc and gbar read
    and z, last, acc written, the table entry read and written, and the
    passes over d at each end)."""
    n, T = val.shape[0], perm.shape[0]
    nnz = (val != 0).sum(1)
    rows = torch.unique(perm)
    read = int(nnz[rows].sum())             # each visited row once
    visits = int(nnz[perm].sum())           # every visit
    nbytes = (read * 12 + len(rows) * 8 + T * 8 + 2 * n * 8 + 4 * d * 8)
    ops = 30 * visits + 10 * T
    touched = (visits * (12 + 8 + 4 + 8 + 8 + 8 + 4 + 8) + T * (16 + 16)
               + d * (8 + 8 + 4 + 8 + 8 + 4 + 8 + 8) + 2 * n * 8)
    bytes_s = nbytes / PEAK_BYTES_S
    ops_s = ops / PEAK_FLOPS["float64"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes, touched)


def lazy_epoch_args(torch, idx, val, b, kind, d, prox_l1):
    """One VR epoch's arguments over sparse rows: a random iterate, table
    and gbar and a permutation, seeded; returns (args, keywords)."""
    n = idx.shape[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    f64 = dict(device="cuda", dtype=torch.float64)
    z = 0.01 * torch.randn(d, generator=g, **f64)
    table = 0.1 * torch.randn(n, generator=g, **f64)
    gbar = 1e-3 * torch.randn(d, generator=g, **f64)
    perm = torch.randperm(n, generator=g, device="cuda")
    eta = 0.05
    return ((idx, val, b, kind, z, table, gbar, perm),
            dict(eta=eta, c=eta * prox_l1, vr=True))


def sparse_rows(lazy, prob):
    """A dense problem's sparse rows as lazy_epoch takes them (``sparsify``):
    (idx, val, b, kind, d)."""
    sp = lazy.sparsify(prob)
    return sp.idx, sp.val, sp.b, sp.kind, sp.d


def ragged_rows(torch, n, d):
    """Rows of varying length at (n, d), ridge (``cases.ragged_rows``: a
    log-normal law of lengths, mean 74 before the cut at 1024, padded to
    the longest with value-0 entries), drawn on the card, seeded. The case
    module is this checkout's even under ``--src``. Returns (idx, val, b,
    kind, d)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "lazy_epoch_cases", ROOT / "src" / "repro_torch" / "kernels"
        / "lazy_epoch" / "cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    g = torch.Generator(device="cuda").manual_seed(10)
    idx, val, _ = cases.ragged_rows(g, n, d, cases.LONGEST)
    b = torch.randn(n, generator=g, device="cuda", dtype=torch.float64)
    return idx, val, b, "ridge", d


def time_lazy_epoch(torch, lazy_kernel, lazy_ref, label, rows, *, prox_l1,
                    plain_ms=None, plain_steps=None):
    """lazy_epoch at one shape (``rows``: idx, val, b, kind, d): device
    time per epoch (CUDA events over back-to-back VR epochs on buffers it
    owns), per step, its bound, its phase split and serial floor
    (``time_lazy_split``); the plain version's time (given, over a whole
    epoch; else measured here over its first ``plain_steps`` steps)."""
    args, kw = lazy_epoch_args(torch, *rows, prox_l1)
    idx, val, perm, z = args[0], args[1], args[7], args[4]
    (n, w), d = idx.shape, z.shape[0]
    outs = (torch.empty_like(z), torch.empty_like(args[5]),
            torch.empty_like(z), torch.empty(d, dtype=torch.int32,
                                             device="cuda"))
    ms = event_ms(torch, lambda: lazy_kernel._launch(*args, *outs, **kw),
                  calls=5)
    if plain_ms is None:
        cut = perm[:plain_steps].contiguous()
        lazy_ref.lazy_epoch_ref(*args[:-1], cut[:20], **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lazy_ref.lazy_epoch_ref(*args[:-1], cut, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    else:
        plain_steps = n
    bound_ms, bound_by, nbytes, touched = lazy_bound(torch, val, perm, d)
    plan = lazy_kernel.launch_plan(w)
    rec = dict(label=label, shape=[n, d, w], T=n, dtype="float64", ms=ms,
               per_step_ms=ms / n, plain_ms=plain_ms,
               plain_steps=plain_steps,
               plain_per_step_ms=plain_ms / plain_steps, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, touched_bytes=touched,
               touched_ms=touched / PEAK_BYTES_S * 1e3,
               bound_share=bound_ms / ms, threads=plan.threads,
               entries=plan.entries, library_ms=None)
    log(f"[time] lazy_epoch {label} (n {n}, d {d}, width {w}): {ms!r} ms an "
        f"epoch, {ms / n * 1e3!r} us a step (CUDA events); plain "
        f"{plain_ms!r} ms over {plain_steps} steps "
        f"({plain_ms / plain_steps * 1e3!r} us a step); bound {bound_ms!r} "
        f"ms ({bound_by}, {nbytes} bytes read or written once), "
        f"{rec['bound_share']!r} of it; the steps touch {touched} bytes "
        f"({rec['touched_ms']!r} ms at the card's rate); {plan.threads} "
        f"threads of {plan.entries} entries; {int((val != 0).sum())} "
        f"nonzero of {val.numel()} entries")
    rec.update(time_lazy_split(torch, lazy_kernel, label, args, outs, kw,
                               rec))
    return rec


def time_lazy_split(torch, lazy_kernel, label, args, outs, kw, rec):
    """lazy_epoch's phase split at one shape, a ``[time]`` line each: the
    probe with no step (the two passes over d alone), the probes that end
    every step after the state load, the catch-up and the reduction
    (``kernel.probe``; they write no ``last``, so their catch-ups span
    from step 0), and the whole steps, each per epoch and per step beyond
    the passes; then the serial floor (the probe ``lazy_epoch_floor`` at
    the plan's threads: shuffle tree, barriers, the residual, a store)
    beside the bound, and which of the two sets the pace."""
    T, ms = rec["T"], rec["ms"]
    split = {}
    for phase in lazy_kernel.PROBES:
        split[phase] = event_ms(torch, lambda: lazy_kernel.probe(
            phase, *args, *outs, **kw), calls=3)
    passes = split["passes"]
    log(f"[time] lazy_epoch {label} split: the passes over d alone "
        f"{passes!r} ms an epoch ({passes / ms!r} of it)")
    for phase in list(lazy_kernel.PROBES)[1:] + [None]:
        t = split.get(phase, ms)
        what = f"steps ending after the {phase}" if phase else "whole steps"
        log(f"[time] lazy_epoch {label} split: {what} {t!r} ms an epoch, "
            f"{(t - passes) / T * 1e3!r} us a step beyond the passes")
    floor = event_ms(torch, lambda: lazy_kernel.serial_floor(
        rec["threads"], T), calls=3)
    paced = "the serial chain" if floor > rec["bound_ms"] else rec["bound_by"]
    log(f"[time] lazy_epoch {label} serial floor (lazy_epoch_floor, "
        f"{rec['threads']} threads): {floor!r} ms an epoch, "
        f"{floor / T * 1e3!r} us a step, {floor / ms!r} of the epoch's "
        f"time; bound {rec['bound_ms']!r} ms ({rec['bound_by']}); paced by "
        f"{paced}")
    return dict(split_ms=split, serial_floor_ms=floor,
                serial_floor_step_ms=floor / T, paced_by=paced)


def dense_epoch_ms(torch, vr_epoch, prob, epochs=RCV1_ROUNDS):
    """The dense fused route's vr_epoch on a problem: CUDA events over
    ``epochs`` back-to-back epoch launches (T = n) at (1, n, d), the state
    in global memory above d 4096."""
    n, d = prob.A.shape
    g = torch.Generator(device="cuda").manual_seed(8)
    f64 = dict(device="cuda", dtype=torch.float64)
    A, b = prob.A[None], prob.b[None]
    orders = torch.randperm(n, generator=g, device="cuda")[None]
    x = 0.01 * torch.randn(1, d, generator=g, **f64)
    table = torch.zeros(1, n, **f64)
    gbar = 1e-3 * torch.randn(1, d, generator=g, **f64)
    acc = torch.empty_like(x)
    kw = dict(lane="centralvr", kind=prob.kind, eta=0.05, decay=0.0, m=n,
              prox=None)
    ms = event_ms(torch, lambda: vr_epoch._launch(A, b, orders, x, table,
                                                  gbar, acc, **kw),
                  calls=epochs)
    plan = vr_epoch.launch_plan(1, d)
    log(f"[time] vr_epoch dense route on the same problem (1, n {n}, d {d},"
        f" T {n}): {ms!r} ms an epoch, {ms / n * 1e3!r} us a step (CUDA "
        f"events, {epochs} epochs); {plan.threads} threads, coords "
        f"{plan.coords} (0: the state in global memory)")
    return dict(ms=ms, per_step_ms=ms / n, epochs=epochs)


def phase_track(torch, kernels):
    """track_iterates on the fused route: Algorithm 1 on toy-logistic, 2
    epochs from the fused init, each tracked epoch one vr_epoch launch
    (3 in all) storing the iterates before each step; held against the
    unfused tracked epochs on the same draws at 1e-9."""
    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import centralvr, convex
    from repro_torch.core import fused as fusedmod

    gen = torch.Generator(device="cuda").manual_seed(9)
    cfg = PRESETS["toy-logistic"]
    prob = convex.make_problem(gen, cfg)
    eta = convex.auto_eta(prob)
    init, per = centralvr.draw_orders(gen, prob.n, 2)
    out = {}
    for fused in (True, False):
        fp = fusedmod.make_params(fused, eta, prob.lam, prob.A.device)
        reset_counts(kernels)
        st = centralvr.init_state(prob, eta, init, fused=fp)
        trajs = []
        for order in per:
            st, traj = centralvr.epoch(prob, st, eta, order,
                                       track_iterates=True, fused=fp)
            trajs.append(traj)
        torch.cuda.synchronize()
        out[fused] = (st, torch.stack(trajs), read_counts(kernels))
    (sf, tf, cf), (su, tu, cu) = out[True], out[False]
    want = dict.fromkeys(kernels, 0)
    want["vr_epoch"] = 3
    diff = max(float((tf - tu).abs().max()), float((sf.x - su.x).abs().max()))
    log(f"[path] track_iterates fused (toy-logistic, 2 epochs): trajectory "
        f"{tuple(tf.shape)}, launches {cf} (unfused {cu}), max |fused - "
        f"unfused| {diff!r}")
    if cf != want or any(cu.values()):
        raise AssertionError(f"track_iterates: launches fused {cf}, unfused "
                             f"{cu}; expected {want} and none")
    if not diff <= 1e-9:
        raise AssertionError(f"track_iterates: fused and unfused differ by "
                             f"{diff}")
    return dict(launches=cf["vr_epoch"], max_diff=diff)


def phase_sparse(torch, kernels):
    """Phase 5b: lazy_epoch against its plain version (a), the README's
    sparse example and the uniform-74 stand-in for rcv1.binary through
    ``solve`` against the dense fused route (b, c), lazy_epoch and
    vr_epoch timed at both, and the fused tracked epoch."""
    import gc

    from repro_torch.kernels.lazy_epoch import ref as lazy_ref
    from repro_torch.prox import lazy

    lazy_kernel = kernels["lazy_epoch"]
    t0 = time.perf_counter()
    err_abs, err_rel, readme_plain_ms = phase_compare_lazy(torch, lazy_kernel,
                                                           lazy_ref)
    gen = torch.Generator(device="cuda").manual_seed(4)
    readme = lazy.make_sparse_data(gen, 4096, 16384, 32)
    # the README's l1 weight is above |grad f(0)|_inf at this scale, so its
    # answer is x = 0; a weight below it gives a real trajectory
    runs = [sparse_pair(torch, kernels, f"README sparse example (4096 x "
                        f"16384, 32 a row, {prox})", readme, SPARSE_ROUNDS,
                        prox) for prox in ("l1:0.001", "l1:1e-6")]
    times = [time_lazy_epoch(torch, lazy_kernel, lazy_ref, "README shape",
                             sparse_rows(lazy, readme), prox_l1=0.001,
                             plain_ms=readme_plain_ms)]
    del readme
    n, d, nnz = RCV1
    torch.cuda.reset_peak_memory_stats()
    rcv1 = lazy.make_sparse_data(gen, n, d, nnz)
    peak = torch.cuda.max_memory_allocated()
    runs += [sparse_pair(torch, kernels, f"uniform-74 stand-in for "
                         f"rcv1.binary ({n} x {d}, {nnz} in every row, "
                         f"{prox})", rcv1, RCV1_ROUNDS, prox)
             for prox in ("l1:1e-5", "l1:1e-7")]
    times.append(time_lazy_epoch(torch, lazy_kernel, lazy_ref,
                                 "uniform-74 stand-in",
                                 sparse_rows(lazy, rcv1), prox_l1=1e-5,
                                 plain_steps=2000))
    dense = dense_epoch_ms(torch, kernels["vr_epoch"], rcv1)
    times[-1]["dense_vr_epoch"] = dense
    log(f"[time] uniform-74 stand-in: lazy_epoch "
        f"{times[-1]['per_step_ms'] * 1e3!r} "
        f"us a step against the dense route's vr_epoch "
        f"{dense['per_step_ms'] * 1e3!r} us a step "
        f"({dense['ms'] / times[-1]['ms']!r}x an epoch); peak memory of the "
        f"draw {peak / 1e9:.2f} GB")
    del rcv1
    lazy._PACK_CACHE.clear()        # it holds the problems' dense A
    gc.collect()
    torch.cuda.empty_cache()
    times.append(time_lazy_epoch(torch, lazy_kernel, lazy_ref,
                                 "varying length", ragged_rows(torch, n, d),
                                 prox_l1=1e-5, plain_steps=2000))
    track = phase_track(torch, kernels)
    log(f"[path] phase 5b (sparse) in {time.perf_counter() - t0:.1f} s")
    return dict(max_abs_err=err_abs, max_rel_err=err_rel, runs=runs,
                times=times, track=track)


def lm_run(torch, cfg, tcfg, W, fused, kernels, sample):
    """One LM run through the entry points a user calls: build the epoch
    runner and the state (seeded), then drive LM_EPOCHS epochs with every
    kernel's count set to 0 just before, and LM_TIMING_EPOCHS more, each
    timed. Returns the run's record, with the losses, the sampled params
    and their update moved to the host; the state is freed."""
    import gc

    from repro_torch.train import step as tstep

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run, meta = tstep.make_epoch_runner(cfg, tcfg, W, fused=fused)
    state = tstep.init_train_state(cfg, tcfg, W)
    p0 = state.params[:, sample].clone()
    torch.cuda.synchronize()
    reset_counts(kernels)
    losses, epoch_s = [], []
    for _ in range(LM_EPOCHS):
        t0 = time.perf_counter()
        state, ls = run(state)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        losses.append(ls)
    counts = read_counts(kernels)
    p1 = state.params[:, sample]
    checksum = float(state.params.sum(dtype=torch.float64))
    timed_s = []
    for _ in range(LM_TIMING_EPOCHS):
        t0 = time.perf_counter()
        state, _ = run(state)
        torch.cuda.synchronize()
        timed_s.append(time.perf_counter() - t0)
    rec = dict(fused=fused, W=W, meta=meta, counts=counts,
               losses=torch.cat(losses).double().cpu(),
               delta=(p1 - p0).double().cpu(), p1=p1.double().cpu(),
               checksum=checksum,
               peak_bytes=torch.cuda.max_memory_allocated(),
               epoch_s=epoch_s, timed_epoch_s=timed_s,
               steps=LM_EPOCHS * meta["comm_every"])
    del state, run, p0, p1, losses
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def steps_per_s(rec):
    """Median, least and most steps/s over a run's timed epochs."""
    rates = sorted(rec["meta"]["comm_every"] / t
                   for t in rec["timed_epoch_s"])
    mid = len(rates) // 2
    median = (rates[mid] if len(rates) % 2
              else (rates[mid - 1] + rates[mid]) / 2)
    return dict(median=median, min=rates[0], max=rates[-1])


def lm_pair(torch, cfg, tcfg, W, kernels, label):
    """The fused run and its unfused twin from the same seed, one after
    the other; checks finiteness, launches per step and agreement."""
    from repro_torch.models import model

    n = model.ParamLayout(cfg).n
    sample = torch.randint(0, n, (min(LM_SAMPLES, n),),
                           generator=torch.Generator().manual_seed(0)
                           ).to("cuda")
    f = lm_run(torch, cfg, tcfg, W, True, kernels, sample)
    u = lm_run(torch, cfg, tcfg, W, False, kernels, sample)
    steps, A = f["steps"], f["meta"]["accum"]
    want = {k: n * steps
            for k, n in expected_launches(cfg, A, W).items()}
    per_step = {k: v / steps for k, v in f["counts"].items()}
    loss_err = float(((f["losses"] - u["losses"]).abs()
                      / u["losses"].abs()).max())
    upd_err = float((f["delta"] - u["delta"]).norm() / u["delta"].norm())
    rate = {name: steps_per_s(r) for name, r in (("fused", f),
                                                  ("unfused", u))}
    log(f"[lm] {label}: fused losses {f['losses'].tolist()}")
    log(f"[lm] {label}: unfused losses {u['losses'].tolist()}")
    log(f"[lm] {label}: launches per step {per_step} (expected "
        f"{ {k: v / steps for k, v in want.items()} }), unfused run "
        f"{u['counts']}")
    log(f"[lm] {label}: agreement epochs fused {f['epoch_s']} s, unfused "
        f"{u['epoch_s']} s; timed epochs fused {f['timed_epoch_s']} s, "
        f"unfused {u['timed_epoch_s']} s")
    for name, r in rate.items():
        log(f"[lm] {label}: {name} steps/s over {LM_TIMING_EPOCHS} epochs: "
            f"median {r['median']!r}, min {r['min']!r}, max {r['max']!r}")
    log(f"[lm] {label}: peak memory fused {f['peak_bytes'] / 1e9:.3f} GB, "
        f"unfused {u['peak_bytes'] / 1e9:.3f} GB; param checksum fused "
        f"{f['checksum']!r}, unfused {u['checksum']!r}")
    log(f"[lm] {label}: max relative loss difference {loss_err!r} "
        f"(tolerance {LOSS_RTOL!r}); update difference in norm {upd_err!r} "
        f"(tolerance {UPDATE_RTOL!r}) on {len(sample)} sampled params")
    for r in (f, u):
        if not bool(torch.isfinite(r["losses"]).all()):
            raise AssertionError(f"{label}: losses not finite: {r['losses']}")
        if not bool(torch.isfinite(r["p1"]).all()):
            raise AssertionError(f"{label}: params not finite")
    if f["counts"] != want:
        raise AssertionError(f"{label}: launches {f['counts']}, expected "
                             f"{want}")
    if any(u["counts"].values()):
        raise AssertionError(f"{label}: the unfused run launched kernels: "
                             f"{u['counts']}")
    if not loss_err <= LOSS_RTOL:
        raise AssertionError(f"{label}: fused and unfused losses differ by "
                             f"{loss_err} (relative)")
    if not upd_err <= UPDATE_RTOL:
        raise AssertionError(f"{label}: fused and unfused updates differ by "
                             f"{upd_err} (relative, in norm)")
    return dict(label=label, counts=f["counts"], per_step=per_step,
                steps=steps, steps_s=rate["fused"],
                unfused_steps_s=rate["unfused"], peak_bytes=f["peak_bytes"],
                unfused_peak_bytes=u["peak_bytes"],
                losses=f["losses"].tolist(), loss_err=loss_err,
                update_err=upd_err)


def expected_launches(cfg, A, W):
    """Launches per step of each kernel with fused=True and remat="block"
    (L layers, A microbatches, W workers): the forward and the block's
    recompute each launch K2 for every block norm (two per attn block, one
    per ssm block) and K3 or K4 once per block, plus K2 once for the final
    norm; K1 once; vr_epoch and lazy_epoch (the convex paths' kernels)
    never."""
    L = cfg.num_layers
    ssm = cfg.family == "ssm"
    norms = 1 if ssm else 2
    return {"vr_update": 1, "vr_epoch": 0, "lazy_epoch": 0,
            "rmsnorm": (2 * norms * L + 1) * A * W,
            "flash_attention": 0 if ssm else 2 * L * A * W,
            "ssd_scan": 2 * L * A * W if ssm else 0}


def lm_configs():
    """The LM main path's configurations: the Qwen2-7B width cut to 2
    layers at W=1, and ``qwen2-7b.reduced()`` for the W=2 run."""
    import dataclasses

    from repro_torch.config import TrainConfig, get_arch

    full = dataclasses.replace(get_arch("qwen2-7b"), num_layers=2)
    tcfg = TrainConfig(seq_len=1024, global_batch=2, microbatch=1,
                       learning_rate=1e-2, optimizer="sgd", vr="centralvr",
                       vr_table_size=2, local_epoch=1, remat="block", seed=0)
    reduced = get_arch("qwen2-7b").reduced()
    tred = dataclasses.replace(tcfg, seq_len=256, global_batch=4,
                               learning_rate=0.1)
    return (full, tcfg), (reduced, tred)


def mamba_configs():
    """Mamba2-130M at its full published width and depth (W=2, A=2), and
    ``mamba2-130m.reduced()`` for a second W=2 run."""
    import dataclasses

    from repro_torch.config import TrainConfig, get_arch

    full = get_arch("mamba2-130m")
    tcfg = TrainConfig(seq_len=2048, global_batch=16, microbatch=4,
                       learning_rate=1e-2, optimizer="sgd", vr="centralvr",
                       vr_table_size=2, local_epoch=1, remat="block", seed=0)
    reduced = full.reduced()
    tred = dataclasses.replace(tcfg, seq_len=256, global_batch=4,
                               microbatch=1, learning_rate=0.1)
    return (full, tcfg), (reduced, tred)


def phase_lm(torch, kernels):
    from repro_torch.models import model

    (full, tcfg), (reduced, tred) = lm_configs()
    log(f"[lm] qwen2-7b width, 2 layers: {full.param_count()} params")
    runs = [lm_pair(torch, full, tcfg, 1, kernels,
                    "qwen2-7b width L=2 W=1 S=1024"),
            lm_pair(torch, reduced, tred, 2, kernels,
                    "qwen2-7b reduced W=2 S=256")]
    (mfull, mtcfg), (mred, mtred) = mamba_configs()
    log(f"[lm] mamba2-130m, full width and depth: "
        f"{model.ParamLayout(mfull).n} params")
    runs += [lm_pair(torch, mfull, mtcfg, 2, kernels,
                     "mamba2-130m L=24 W=2 S=2048"),
             lm_pair(torch, mred, mtred, 2, kernels,
                     "mamba2-130m reduced W=2 S=256")]
    return runs


# ---------------------------------------------------------------------------
# Phase 4c: the spmd backend, one worker per rank over torch.distributed
# ---------------------------------------------------------------------------

SPMD_TOL = 1e-9                 # against the vmap fused run, relative
SPMD_PS_SVRG_N = 125            # PS-SVRG's n per worker in phase 4c
SPMD_PROBE_CALLS = 100          # all-reduces timed after the convex runs
LM_TOL = dict(rtol=3e-5, atol=1e-6)   # the CPU tests' LM tolerance


def kernel_modules():
    """The wrappers of the six kernels, by name (each with its count)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.vr_update import epoch as vr_epoch
    from repro_torch.kernels.vr_update import kernel as vr_kernel
    return {"vr_update": vr_kernel, "vr_epoch": vr_epoch,
            "lazy_epoch": lazy_kernel, "rmsnorm": rms_kernel,
            "flash_attention": fa_kernel, "ssd_scan": ssd_kernel}


def _numpy(draws):
    """A run's draws as numpy (tuples kept, None kept), for a rank."""
    if isinstance(draws, tuple):
        return tuple(_numpy(d) for d in draws)
    return None if draws is None else draws.cpu().numpy()


def spmd_convex_runs(torch):
    """Phase 4c's convex runs on §6.2's ``dist-toy-logistic`` (p 8, 5000 x
    1000 per worker, float64): Algorithm 2 with phase 4's rounds, the
    others with phase 5's, every VR run fused. PS-SVRG's server steps
    (2*ns a round) each wait for an all-reduce over the 8 ranks, ~22 ms
    over gloo on an H100's host (the ``[spmd]`` all-reduce probe), so its
    run cuts n per worker to ``SPMD_PS_SVRG_N``. Draws made once here. Each:
    (label, config, spec, draws, vr_epoch launches of each rank (one per
    fused epoch call: the init epoch, each round, each event the rank
    owns), inner steps, VR algorithm)."""
    import dataclasses

    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import baselines as bl
    from repro_torch.core import distributed as ds
    from repro_torch.core import runtime

    gen = torch.Generator(device="cuda").manual_seed(3)
    net = PRESETS["dist-toy-logistic"]
    p, ns = net.workers, net.n
    speeds = tuple(1.0 + i for i in range(p))
    blocks = max(ns // 16, 1)
    ps_net = dataclasses.replace(net, n=SPMD_PS_SVRG_N)

    def owned(rounds, sp=None):
        sched = runtime.event_schedule(p, rounds, sp)
        return [int((sched == r).sum()) for r in range(p)]

    return [
        ("centralvr_sync", net,
         dict(algo="centralvr_sync", p=p, rounds=ROUNDS, fused=True),
         ds.draw_sync_orders(gen, p, ns, ROUNDS), [ROUNDS + 1] * p,
         (ROUNDS + 1) * ns, True),
        ("centralvr_async round-robin", net,
         dict(algo="centralvr_async", p=p, rounds=2, fused=True),
         ds.draw_async_orders(gen, p, ns, 2), [1 + k for k in owned(2)],
         ns + 2 * p * ns, True),
        ("centralvr_async speeds 1..8", net,
         dict(algo="centralvr_async", p=p, rounds=2, speeds=speeds,
              fused=True),
         ds.draw_async_orders(gen, p, ns, 2),
         [1 + k for k in owned(2, speeds)], ns + 2 * p * ns, True),
        ("dsvrg (tau 2*ns)", net, dict(algo="dsvrg", p=p, rounds=3,
                                       fused=True),
         ds.draw_dsvrg_orders(gen, p, ns, 3, 2 * ns), [3] * p, 3 * 2 * ns,
         True),
        ("dsaga stale (tau 100)", net,
         dict(algo="dsaga", p=p, rounds=20, tau=100, fetch="stale",
              fused=True),
         ds.draw_dsaga_orders(gen, p, ns, 20, 100), owned(20),
         20 * p * 100, True),
        ("dist_sgd (tau ns)", net, dict(algo="dist_sgd", p=p, rounds=2),
         bl.draw_dist_sgd_orders(gen, p, ns, 2, ns), [0] * p, 2 * ns, False),
        ("easgd (tau 16)", net, dict(algo="easgd", p=p, rounds=2),
         bl.draw_easgd_orders(gen, p, ns, 2, 16), [0] * p, 2 * blocks * 16,
         False),
        (f"ps_svrg (n {SPMD_PS_SVRG_N} per worker, 2*ns steps)", ps_net,
         dict(algo="ps_svrg", p=p, rounds=2),
         bl.draw_ps_svrg_orders(gen, p, SPMD_PS_SVRG_N, 2), [0] * p,
         2 * 2 * SPMD_PS_SVRG_N, False),
    ]


def spmd_world_runs(torch, world):
    """The NCCL run, CentralVR-Sync on ``dist-toy-logistic``'s workers cut
    to ``world`` (the card count), 10 rounds fused; and, in a group of one
    rank, Algorithm 1 on ``millionsong`` (10 epochs, fused)."""
    import dataclasses

    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import centralvr
    from repro_torch.core import distributed as ds

    gen = torch.Generator(device="cuda").manual_seed(4)
    net, ms = PRESETS["dist-toy-logistic"], PRESETS["millionsong"]
    ns, n = net.n, ms.n
    sync = (f"centralvr_sync p={world} over nccl",
            dataclasses.replace(net, workers=world),
            dict(algo="centralvr_sync", p=world, rounds=ROUNDS, fused=True),
            ds.draw_sync_orders(gen, world, ns, ROUNDS),
            [ROUNDS + 1] * world, (ROUNDS + 1) * ns, True)
    alg1 = ("centralvr millionsong (world 1)", ms,
            dict(algo="centralvr", rounds=ROUNDS, fused=True),
            centralvr.draw_orders(gen, n, ROUNDS), [ROUNDS + 1],
            (ROUNDS + 1) * n, True)
    return sync, alg1


def spmd_rank_convex(group, runs):
    """In a rank: every run through ``solve(backend="spmd")`` on its
    config, each count set to 0 just before and read just after, the
    ranks lined up by a barrier before each."""
    import torch
    import torch.distributed as dist

    from repro_torch import RunSpec, solve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_modules()
    out = []
    for label, cfg, spec, draws, *_ in runs:
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = solve(RunSpec(backend="spmd", **spec), cfg, orders=draws,
                    group=group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.append(dict(label=label, x=res.x, rels=res.rels,
                        counts=read_counts(kernels), launches=res.launches,
                        wall_s=wall, device=str(group.device),
                        device_name=res.device, rank=group.rank,
                        world=group.world, transport=group.transport,
                        carried_bytes=res.comms["carried_bytes"],
                        collectives=res.comms["collectives"]))
    # the latency of one collective as the runs make it: an all-reduce
    # of a (1000,) float64 vector on the card (PS-SVRG's a server step)
    from repro_torch.core import spmd
    t = torch.ones(1000, dtype=torch.float64, device=group.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(SPMD_PROBE_CALLS):
        spmd.psum_(t, group)
    torch.cuda.synchronize()
    out.append(dict(label="all-reduce probe",
                    ms=(time.perf_counter() - t0) * 1e3 / SPMD_PROBE_CALLS))
    return out


def spmd_vmap(torch, runs, kernels):
    """The parent's vmap run of each spmd run, on the same draws: (x,
    rels, wall)."""
    from repro_torch import RunSpec, solve

    out = []
    for label, cfg, spec, draws, *_ in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(RunSpec(**spec), cfg, orders=draws)
        torch.cuda.synchronize()
        out.append(dict(x=res.x, rels=res.rels,
                        wall_s=time.perf_counter() - t0))
    return out


def spmd_check(torch, runs, vmap, ranks):
    """Phase 4c's gates on one group's runs: each rank on the card;
    vr_epoch launched by each rank exactly once per fused epoch call and
    nothing else; x and rels bit-identical across ranks, within 1e-9 of
    the vmap run (relative), finite, falling for the VR algorithms.
    Prints the ``[spmd]`` lines; returns the runs' records."""
    import numpy as np

    name = torch.cuda.get_device_name(0)
    recs = []
    for i, (label, _, spec, _, launches, steps, vr) in enumerate(runs):
        mine = [r[i] for r in ranks]
        first, v = mine[0], vmap[i]
        for r, rec in enumerate(mine):
            want = dict.fromkeys(rec["counts"], 0)
            want["vr_epoch"] = launches[r]
            if rec["counts"] != want:
                raise AssertionError(f"[spmd] {label}: rank {r} launched "
                                     f"{rec['counts']}, expected {want}")
            if not (rec["device"].startswith("cuda")
                    and rec["device_name"] == name):
                raise AssertionError(f"[spmd] {label}: rank {r} ran on "
                                     f"{rec['device']} ({rec['device_name']})")
            if not (np.array_equal(rec["x"], first["x"])
                    and np.array_equal(rec["rels"], first["rels"])):
                raise AssertionError(f"[spmd] {label}: rank {r}'s x or rels "
                                     "differ from rank 0's")
        scale = max(float(np.abs(v["x"]).max()), 1e-300)
        dx = float(np.abs(first["x"] - v["x"]).max()) / scale
        drel = float((np.abs(first["rels"] - v["rels"])
                      / np.abs(v["rels"])).max())
        rels = first["rels"]
        wall = max(r["wall_s"] for r in mine)
        log(f"[spmd] {label}: {first['transport']}, world "
            f"{first['world']}, devices "
            f"{sorted({r['device'] for r in mine})}; rels "
            f"{[float(x) for x in rels]}")
        log(f"[spmd] {label}: wall {wall!r} s ({steps / wall!r} inner "
            f"steps/s) against the vmap run's {v['wall_s']!r} s "
            f"({steps / v['wall_s']!r}); vr_epoch launches per rank "
            f"{launches}; carried {first['carried_bytes']} bytes in "
            f"{first['collectives']} collectives a rank; |x - vmap| "
            f"{dx!r}, |rels - vmap| {drel!r} (relative)")
        if not np.isfinite(rels).all() or (vr and not rels[-1] < rels[0]):
            raise AssertionError(f"[spmd] {label}: rels {rels}")
        if not (dx <= SPMD_TOL and drel <= SPMD_TOL):
            raise AssertionError(f"[spmd] {label}: {dx} / {drel} from the "
                                 "vmap run")
        recs.append(dict(label=label, transport=first["transport"],
                         world=first["world"], wall_s=wall,
                         vmap_wall_s=v["wall_s"], inner_steps=steps,
                         launches_per_rank=launches,
                         carried_bytes=first["carried_bytes"],
                         collectives=first["collectives"], max_dx=dx,
                         max_drel=drel))
    return recs


def spmd_rank_lm(group, sample):
    """In a rank: Mamba2-130M at full width and depth, its worker of W = 2
    through ``make_epoch_runner(backend="spmd", fused=True)``, 2 epochs
    from the seeded state (``place_train_state``), counts set to 0 just
    before."""
    import torch

    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (cfg, tcfg), _ = mamba_configs()
    run, meta = tstep.make_epoch_runner(cfg, tcfg, 2, backend="spmd",
                                        fused=True, group=group)
    state = tstep.place_train_state(
        tstep.init_train_state(cfg, tcfg, 2, device=group.device), group)
    torch.cuda.empty_cache()
    kernels = kernel_modules()
    carried0 = group.carried_bytes
    torch.cuda.synchronize()
    reset_counts(kernels)
    losses, epoch_s = [], []
    for _ in range(LM_EPOCHS):
        t0 = time.perf_counter()
        state, ls = run(state)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        losses.append(ls)
    return dict(losses=torch.cat(losses).double().cpu(),
                p1=state.params[0, torch.as_tensor(sample,
                                                   device=group.device)]
                .double().cpu(),
                counts=read_counts(kernels), epoch_s=epoch_s,
                steps=LM_EPOCHS * meta["comm_every"], accum=meta["accum"],
                shape=list(state.params.shape), device=str(group.device),
                transport=group.transport,
                carried_bytes=group.carried_bytes - carried0)


def spmd_lm(torch, mesh):
    """Mamba2-130M W = 2 over 2 ranks sharing the card against the vmap
    W = 2 run from the same seed (its 2 epochs run here first, then
    freed): losses and the sampled params within LM_TOL, bit-identical
    across ranks, launches per step as a W = 1 step's."""
    import gc

    from repro_torch.models import model
    from repro_torch.train import step as tstep

    (cfg, tcfg), _ = mamba_configs()
    n = model.ParamLayout(cfg).n
    sample = torch.randint(0, n, (min(LM_SAMPLES, n),),
                           generator=torch.Generator().manual_seed(0))
    run, meta = tstep.make_epoch_runner(cfg, tcfg, 2, fused=True)
    state = tstep.init_train_state(cfg, tcfg, 2)
    losses, vmap_s = [], []
    for _ in range(LM_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ls = run(state)
        torch.cuda.synchronize()
        vmap_s.append(time.perf_counter() - t0)
        losses.append(ls)
    want_losses = torch.cat(losses).double().cpu()
    want_p1 = state.params[:, sample.to(state.params.device)].double().cpu()
    del state, run, losses
    gc.collect()
    torch.cuda.empty_cache()
    ranks = mesh.spawn_workers(2, spmd_rank_lm, sample.numpy())
    label = "mamba2-130m L=24 W=2 S=2048"
    steps, A = ranks[0]["steps"], ranks[0]["accum"]
    want = {k: v * steps for k, v in expected_launches(cfg, A, 1).items()}
    for r, rec in enumerate(ranks):
        if rec["counts"] != want:
            raise AssertionError(f"[spmd] {label}: rank {r} launched "
                                 f"{rec['counts']}, expected {want}")
        if not (rec["device"].startswith("cuda") and rec["shape"][0] == 1):
            raise AssertionError(f"[spmd] {label}: rank {r} on "
                                 f"{rec['device']}, params {rec['shape']}")
        if not (torch.equal(rec["losses"], ranks[0]["losses"])
                and torch.equal(rec["p1"], ranks[0]["p1"])):
            raise AssertionError(f"[spmd] {label}: rank {r} differs from "
                                 "rank 0")
        torch.testing.assert_close(rec["losses"], want_losses, **LM_TOL)
        for w in range(2):
            torch.testing.assert_close(rec["p1"], want_p1[w], **LM_TOL)
    got = ranks[0]
    loss_err = float(((got["losses"] - want_losses).abs()
                      / want_losses.abs()).max())
    p_err = float((got["p1"] - want_p1[0]).abs().max())
    log(f"[spmd] {label}: {got['transport']}, world 2, devices "
        f"{sorted({r['device'] for r in ranks})}; losses "
        f"{got['losses'].tolist()}; max relative loss difference from the "
        f"vmap run {loss_err!r}, sampled params {p_err!r} (absolute)")
    log(f"[spmd] {label}: epochs {[r['epoch_s'] for r in ranks]} s by rank "
        f"against the vmap run's {vmap_s} s; launches per step "
        f"{ {k: v / steps for k, v in got['counts'].items()} }; carried "
        f"{got['carried_bytes']} bytes a rank")
    return dict(label=label, epoch_s=[r["epoch_s"] for r in ranks],
                vmap_epoch_s=vmap_s, loss_err=loss_err, param_err=p_err,
                counts=[r["counts"] for r in ranks],
                carried_bytes=got["carried_bytes"])


def phase_spmd(torch, kernels):
    """Phase 4c: the spmd backend on the card. The convex runs over 8
    ranks (``spawn_workers``; the transport that "auto" picks, gloo on
    one card), Algorithm 1 in a group of one rank, CentralVR-Sync over
    NCCL at world = the card count, and Mamba2-130M over 2 ranks; each
    held against the vmap run in this process on the same draws."""
    from repro_torch.launch import mesh

    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    convex = spmd_convex_runs(torch)
    sync, alg1 = spmd_world_runs(torch, world)
    every = convex + [sync, alg1]
    vmap = spmd_vmap(torch, every, kernels)
    host = [r[:3] + (_numpy(r[3]),) + r[4:] for r in every]
    torch.cuda.empty_cache()
    p = convex[0][2]["p"]
    rule = mesh.pick_transport("auto", torch.device("cuda", 0), p)
    log(f"[spmd] transport rule: {rule} for {p} ranks on {world} card(s), "
        f"nccl for {world} rank(s)")
    ranks = mesh.spawn_workers(p, spmd_rank_convex, host[:len(convex)])
    probe = [r.pop()["ms"] for r in ranks]
    log(f"[spmd] one all-reduce of a (1000,) float64 vector over {p} ranks "
        f"({ranks[0][0]['transport']}, staged through pinned host memory): "
        f"{max(probe)!r} ms (slowest rank's mean over {SPMD_PROBE_CALLS})")
    recs = spmd_check(torch, convex, vmap[:len(convex)], ranks)
    if world == 1:
        ranks = mesh.spawn_workers(1, spmd_rank_convex, host[-2:],
                                   transport="nccl")
        recs += spmd_check(torch, [sync, alg1], vmap[-2:],
                           [r[:-1] for r in ranks])
    else:
        ranks = mesh.spawn_workers(world, spmd_rank_convex, host[-2:-1],
                                   transport="nccl")
        recs += spmd_check(torch, [sync], vmap[-2:-1],
                           [r[:-1] for r in ranks])
        ranks = mesh.spawn_workers(1, spmd_rank_convex, host[-1:])
        recs += spmd_check(torch, [alg1], vmap[-1:], [r[:-1] for r in ranks])
    recs.append(dict(label="all-reduce probe", world=p, ms=max(probe)))
    lm = spmd_lm(torch, mesh)
    launches = {"vr_epoch": sum(sum(r[4]) for r in every)}
    for name, n in lm["counts"][0].items():
        launches[name] = launches.get(name, 0) + n * len(lm["counts"])
    log(f"[path] phase 4c (spmd) in {time.perf_counter() - t0:.1f} s")
    return dict(runs=recs, lm=lm, launches=launches)


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


def cold_graph_ms(torch, fn, xs, calls=200, replays=20):
    """``graph_ms`` of ``fn(x)`` with x taken in turn from ``xs`` and every
    call's output kept (a buffer of its own in the graph's pool): between
    two uses of an input or an output buffer the calls move more than
    the 50 MB L2 holds, so each call reads its input and writes its
    output from and to device memory, as a layer of the model does."""
    turn, outs = itertools.cycle(xs), []
    ms = graph_ms(torch, lambda: outs.append(fn(next(turn))), calls, replays)
    del outs
    torch.cuda.empty_cache()
    return ms


def time_rmsnorm(torch, rms_kernel, rms_ref, rows=1024, d=3584):
    # enough inputs that a call's input was last read more than twice the
    # L2's 50 MB ago, counting each call's input and output bytes
    moved = 2 * rows * d * 2
    xs = [torch.randn(rows, d, device="cuda").to(torch.bfloat16)
          for _ in range(-(-2 * L2_BYTES // moved) + 1)]
    s = torch.randn(d, device="cuda").to(torch.bfloat16)
    fns = {"ms": lambda x: rms_kernel.rmsnorm(x, s),
           "plain_ms": lambda x: rms_ref.rmsnorm_ref(x, s),
           "library_ms": lambda x: torch.nn.functional.rms_norm(
               x, (d,), s, 1e-6)}
    rec = {k: cold_graph_ms(torch, f, xs) for k, f in fns.items()}
    x = xs[0]
    rec["eager_ms"] = eager_ms(torch, lambda: fns["ms"](x))
    # x read once, y written once (scale is d elements)
    bytes_s = (2 * rows * d + d) * 2 / PEAK_BYTES_S
    ops_s = RMS_OPS_PER_ELEMENT * rows * d / PEAK_FLOPS["float32"]
    rec.update(shape=[rows, d], dtype="bfloat16",
               bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="bytes" if bytes_s >= ops_s else "operations")
    rec["inputs"] = len(xs)
    log(f"[time] rmsnorm {rec['shape']} bf16: kernel {rec['ms']!r} ms/launch "
        f"(graph replay, L2 cold: {len(xs)} inputs in turn, every output "
        f"kept), {rec['eager_ms']!r} ms from Python (warm); plain "
        f"{rec['plain_ms']!r} ms; F.rms_norm {rec['library_ms']!r} ms; bound "
        f"{rec['bound_ms']!r} ms ({rec['bound_by']})")
    return rec


def time_flash(torch, fa_kernel, fa_ref, B=1, S=1024, H=28, KV=4, hd=128,
               dtype="bfloat16"):
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, hd, device="cuda").to(dt)
    k = torch.randn(B, S, KV, hd, device="cuda").to(dt)
    v = torch.randn(B, S, KV, hd, device="cuda").to(dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel = lambda: fa_kernel.flash_attention(q, k, v)        # noqa: E731
    rec = {"ms": graph_ms(torch, kernel, calls=50, replays=10),
           "plain_ms": graph_ms(torch, lambda: fa_ref.flash_attention_ref(
               q, k, v), calls=2, replays=3),
           "library_ms": graph_ms(
               torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               calls=50, replays=10),
           "eager_ms": eager_ms(torch, kernel, calls=200)}
    # causal: the score and value products over the S(S+1)/2 visible pairs;
    # bf16 on the tensor cores, float32 outside them
    flops = 2 * 2 * (S * (S + 1) // 2) * hd * H * B
    bytes_s = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
               / PEAK_BYTES_S)
    ops_s = flops / PEAK_FLOPS["bf16_tensor" if dtype == "bfloat16"
                               else "float32"]
    rec.update(shape=[B, S, H, KV, hd], dtype=dtype, flops=flops,
               bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="bytes" if bytes_s >= ops_s else "operations")
    rec.update(tflops=flops / rec["ms"] / 1e9,
               library_tflops=flops / rec["library_ms"] / 1e9,
               bound_share=rec["bound_ms"] / rec["ms"])
    log(f"[time] flash_attention {rec['shape']} {dtype}: kernel {rec['ms']!r} "
        f"ms/launch (graph replay), {rec['eager_ms']!r} ms from Python, "
        f"{rec['tflops']!r} TFLOP/s, {rec['bound_share']!r} of the bound; "
        f"plain {rec['plain_ms']!r} ms; SDPA {rec['library_ms']!r} ms, "
        f"{rec['library_tflops']!r} TFLOP/s; bound {rec['bound_ms']!r} ms "
        f"({rec['bound_by']}, {flops} flop)")
    return rec


def time_ssd(torch, ssd_kernel, ssd_ref, B=4, S=2048, H=24, P=64, N=128,
             Q=64):
    """K4 at Mamba2-130M's training shape, as the block calls it (the
    model-layout entry); plain version on the same inputs. The operations
    count the causal halves of C B^T and w x (the Q(Q+1)/2 visible pairs),
    C h^T and the state update; the bytes are la, x, B, C read and y
    written once. The bound is the larger of the bytes at HBM's rate and
    the operations at the TF32 tensor-core rate (the kernel's products run
    there); beside it, the 3xTF32 floor (three passes of every product)
    and the figure of the first port, float32 outside the tensor cores."""
    ins = ssd_inputs(torch, B, S, H, P, N, seed=20)
    kernel = lambda: ssd_kernel.ssd_scan(*ins, chunk=Q)        # noqa: E731
    before = ssd_kernel.launches
    kernel()
    torch.cuda.synchronize()
    per_call = ssd_kernel.launches - before
    if per_call != 1:
        raise AssertionError(f"ssd_scan launched {per_call} kernels in one "
                             f"call, expected 1")
    rec = {"ms": graph_ms(torch, kernel, calls=20, replays=10),
           "plain_ms": graph_ms(torch, lambda: ssd_plain(
               torch, ssd_ref, *ins, Q), calls=2, replays=3),
           "eager_ms": eager_ms(torch, kernel, calls=100)}
    nc = -(-S // Q)
    pairs = Q * (Q + 1) // 2
    flops = 2 * B * H * nc * (pairs * (N + P) + 2 * Q * N * P)
    nbytes = 4 * (B * S * H + 2 * B * S * H * P + 2 * B * S * N)
    bytes_s = nbytes / PEAK_BYTES_S
    ops_s = flops / PEAK_FLOPS["tf32_tensor"]
    rec.update(shape=[B, S, H, P, N, Q], dtype="float32", flops=flops,
               bytes=nbytes, bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="bytes" if bytes_s >= ops_s else "operations",
               bound_3xtf32_ms=3 * ops_s * 1e3,
               bound_float32_ms=flops / PEAK_FLOPS["float32"] * 1e3,
               launches_per_call=per_call, library_ms=None)
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"[time] ssd_scan {rec['shape']} float32: kernel {rec['ms']!r} "
        f"ms/launch (graph replay), {rec['eager_ms']!r} ms from Python, "
        f"{per_call} launch per call; plain {rec['plain_ms']!r} ms; bound "
        f"{rec['bound_ms']!r} ms ({rec['bound_by']}, {nbytes} bytes; "
        f"{flops} flop: {ops_s * 1e3!r} ms at TF32, 3xTF32 floor "
        f"{rec['bound_3xtf32_ms']!r} ms, float32 outside the tensor cores "
        f"{rec['bound_float32_ms']!r} ms), {rec['bound_share']!r} of the "
        f"bound")
    return rec


def event_ms(torch, fn, calls):
    """Device time per call of ``fn`` between two CUDA events, for calls
    long enough (milliseconds) that launch overhead does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def vr_update_lm(torch, vr_kernel, vr_ref, shape, timed):
    """K1 at an LM step's shape: one launch over the (W, N) float32
    buffers, as ``vr_wrapper.apply`` makes it for centralvr (x, g, g_old,
    gbar, gtilde read; x' and gtilde' written in place). First held
    against the plain version: the kernel writes into clones of x and
    gtilde, the plain version reads the untouched inputs one slice at a
    time (it is elementwise; whole, its temporaries would not fit beside
    the inputs at full width), and x' and gtilde' must agree within 1e-6
    of their largest magnitude. Then, if ``timed``, both are timed with
    CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ts = [torch.empty(shape, device="cuda").normal_(generator=gen)
          for _ in range(5)]
    x, g, g_old, gbar, gtilde = ts
    kw = dict(eta=1e-2, m=2, saga=False)
    x_out, gt_out = x.clone(), gtilde.clone()
    vr_kernel.vr_update(x_out, g, g_old, gbar, gt_out, inplace=True, **kw)
    torch.cuda.synchronize()
    chunk = 1 << 26
    err = {"x": 0.0, "gtilde": 0.0}
    scale = {"x": 0.0, "gtilde": 0.0}
    for w in range(shape[0]):
        for lo in range(0, shape[1], chunk):
            sl = (w, slice(lo, lo + chunk))
            want_x, _, want_gt, _ = vr_ref.vr_update_ref(
                *(t[sl] for t in ts), **kw)
            for key, got, want in (("x", x_out[sl], want_x),
                                   ("gtilde", gt_out[sl], want_gt)):
                err[key] = max(err[key], (got - want).abs().max().item())
                scale[key] = max(scale[key], want.abs().max().item())
    del x_out, gt_out
    torch.cuda.empty_cache()
    rec = dict(shape=list(shape), dtype="float32",
               max_abs_err=max(err.values()), max_abs_err_x=err["x"],
               max_abs_err_gtilde=err["gtilde"])
    log(f"[compare] vr_update {list(shape)} float32 (LM step): max abs err "
        f"x' {err['x']!r}, gtilde' {err['gtilde']!r} (tolerance 1e-6 of "
        f"the largest magnitude: {scale['x']!r}, {scale['gtilde']!r})")
    for key in err:
        if not err[key] <= 1e-6 * scale[key]:
            raise AssertionError(f"vr_update {list(shape)} float32: {key}' "
                                 f"max abs err {err[key]} > "
                                 f"{1e-6 * scale[key]}")
    if timed:
        rec["plain_ms"] = event_ms(
            torch, lambda: vr_ref.vr_update_ref(*ts, **kw), calls=3)
        rec["ms"] = event_ms(torch, lambda: vr_kernel.vr_update(
            *ts, inplace=True, **kw), calls=10)
        n = shape[0] * shape[1]
        bytes_s = VR_STREAMS * n * 4 / PEAK_BYTES_S
        ops_s = VR_OPS_PER_ELEMENT * n / PEAK_FLOPS["float32"]
        rec.update(bound_ms=max(bytes_s, ops_s) * 1e3,
                   bound_by="bytes" if bytes_s >= ops_s else "operations")
        log(f"[time] vr_update {list(shape)} float32: kernel {rec['ms']!r} "
            f"ms/launch (CUDA events), plain {rec['plain_ms']!r} ms; bound "
            f"{rec['bound_ms']!r} ms ({rec['bound_by']})")
    del ts, x, g, g_old, gbar, gtilde
    torch.cuda.empty_cache()
    return rec


def epoch_bound(p, d, T, unique, lane):
    """The least time of one epoch at the card's peak rates, from this
    run's inputs: bytes are each visited row, label and table entry once
    (``unique`` distinct (worker, index) pairs), the orders, x in and out,
    gbar in (and out with saga), acc out, the table written back
    (centralvr, saga); operations ~11 a coordinate a step (dot 2, g and
    g_old 2, v 2, x 3, acc or gbar 2-3) and ~10 a step for the residual,
    in float64. Returns (bound ms, bytes or operations, bytes)."""
    table_out = 0 if lane == "svrg" else unique
    nbytes = 8 * (unique * d + 2 * unique + table_out + p * T
                  + p * d * (4 if lane == "saga" else 3))
    ops = p * T * (11 * d + 10)
    bytes_s = nbytes / PEAK_BYTES_S
    ops_s = ops / PEAK_FLOPS["float64"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes)


def epoch_kernel_ms(torch, vr_epoch, p, n, d, T, lane, repeats, kind):
    """vr_epoch's device time per epoch at one shape: CUDA events over
    back-to-back launches in place. Returns (ms, inputs, keywords)."""
    ins = epoch_inputs(torch, p, n, d, T, repeats=repeats, kind=kind,
                       seed=50)
    A, b, orders, x, table, gbar = ins
    kw = dict(lane=lane, kind=kind, eta=1e-3, decay=2e-4, m=n * p,
              prox=None)
    outs = (x.clone(), table.clone(), gbar.clone(),
            torch.empty_like(x) if lane == "centralvr" else None)
    calls = max(3, min(200, 200000 // T))
    ms = event_ms(torch, lambda: vr_epoch._launch(A, b, orders, *outs, **kw),
                  calls)
    return ms, ins, kw


def time_vr_epoch(torch, vr_epoch, vr_ref, label, p, n, d, T, lane,
                  repeats, kind="logistic"):
    """vr_epoch at one convex path's shape: its device time per epoch
    (``epoch_kernel_ms``), its plain version's time over the whole epoch
    (host loop of ~10 launches a step, after a 20-step warm-up), the
    bound, and the serial floor (the probe's chain per step times T). The
    pace is set by the larger of bound and floor."""
    ms, ins, kw = epoch_kernel_ms(torch, vr_epoch, p, n, d, T, lane,
                                  repeats, kind)
    A, b, orders, x, table, gbar = ins
    vr_ref.vr_epoch_ref(A, b, orders[:, :20].contiguous(), x, table, gbar,
                        **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vr_ref.vr_epoch_ref(*ins, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plan = vr_epoch.launch_plan(p, d)
    floor_calls = 5
    floor_ms = event_ms(torch, lambda: vr_epoch.serial_floor(
        p, plan.threads, T), floor_calls)
    unique = sum(len(torch.unique(orders[w])) for w in range(p))
    bound_ms, bound_by, nbytes = epoch_bound(p, d, T, unique, lane)
    rec = dict(label=label, shape=[p, n, d], T=T, lane=lane, dtype="float64",
               ms=ms, per_step_ms=ms / T, plain_ms=plain_ms,
               plain_per_step_ms=plain_ms / T,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               serial_floor_ms=floor_ms, serial_floor_step_ms=floor_ms / T,
               paced_by=("the serial chain" if floor_ms > bound_ms
                         else bound_by),
               bound_share=bound_ms / ms, floor_share=floor_ms / ms,
               threads=plan.threads, coords=plan.coords, library_ms=None)
    log(f"[time] vr_epoch {label} (p {p}, n {n}, d {d}, T {T}, {lane}): "
        f"{ms!r} ms an epoch, {ms / T * 1e3!r} us a step (CUDA events); "
        f"plain {plain_ms!r} ms an epoch ({plain_ms / T * 1e3!r} us a "
        f"step); bound {bound_ms!r} ms "
        f"({bound_by}, {nbytes} bytes), {rec['bound_share']!r} of it; "
        f"serial floor {floor_ms / T * 1e3!r} us a step ({floor_ms!r} ms an "
        f"epoch, {rec['floor_share']!r} of the epoch's time); paced by "
        f"{rec['paced_by']}; {plan.threads} threads of {plan.coords} "
        f"coordinates")
    return rec


# the convex paths' vr_epoch calls: (label, p, n, d, T, lane, repeats, kind)
EPOCH_SHAPES = [
    ("centralvr_sync round", 8, 5000, 1000, 5000, "centralvr", False,
     "logistic"),
    ("centralvr millionsong epoch", 1, 46371, 90, 46371, "centralvr", False,
     "ridge"),
    ("Fig. 1 centralvr epoch", 1, 5000, 20, 5000, "centralvr", False,
     "logistic"),
    ("Fig. 1 saga epoch", 1, 5000, 20, 5000, "saga", True, "logistic"),
    ("Fig. 1 svrg epoch", 1, 5000, 20, 5000, "svrg", True, "logistic"),
    ("centralvr_async event", 1, 5000, 1000, 5000, "centralvr", False,
     "logistic"),
    ("dsvrg round", 8, 5000, 1000, 10000, "svrg", True, "logistic"),
    ("dsaga event", 1, 5000, 1000, 100, "saga", True, "logistic"),
]


def phase_rates(torch):
    """Inner steps/s of every fused VR run of phases 4 and 5 through
    ``solve`` alone (no gates, no unfused twin), after one small fused
    solve that builds the kernel, and vr_epoch's device time at each
    path's shape (``EPOCH_SHAPES``); for holding two checkouts of the port
    against each other on one card (``--rates``, ``--src``). Returns (the
    runs, the kernel's times)."""
    import numpy as np

    from repro_torch import RunSpec, solve
    from repro_torch.config import ConvexConfig

    t0 = time.perf_counter()
    solve(RunSpec("saga", rounds=1, fused=True),
          ConvexConfig(problem="logistic", n=40, d=24))
    torch.cuda.synchronize()
    log(f"[rates] warm-up (kernel build) {time.perf_counter() - t0:.1f} s")
    kernel = []
    try:
        from repro_torch.kernels.vr_update import epoch as vr_epoch
    except ImportError:     # a checkout from before the epoch route
        log("[rates] no vr_epoch in this checkout")
        shapes = []
    else:
        shapes = EPOCH_SHAPES
    for label, p, n, d, T, lane, repeats, kind in shapes:
        ms = epoch_kernel_ms(torch, vr_epoch, p, n, d, T, lane, repeats,
                             kind)[0]
        log(f"[rates] vr_epoch {label} (p {p}, n {n}, d {d}, T {T}, "
            f"{lane}): {ms!r} ms an epoch, {ms / T * 1e3!r} us a step")
        kernel.append(dict(label=label, ms=ms, per_step_ms=ms / T))
    lazy_times = rates_lazy(torch)
    out = []
    for label, spec, cfg, draws, _, steps, _, vr in (main_runs(torch)
                                                     + family_runs(torch)):
        if not vr:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(RunSpec(fused=True, **spec), cfg, orders=draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not np.isfinite(res.rels).all():
            raise AssertionError(f"{label}: rels not finite: {res.rels}")
        log(f"[rates] {label}: fused wall {wall!r} s, {steps / wall!r} "
            f"inner steps/s, launches {res.launches}, last rel "
            f"{float(res.rels[-1])!r}")
        out.append(dict(label=label, wall_s=wall, inner_steps=steps,
                        inner_steps_s=steps / wall, launches=res.launches))
    return out, kernel, lazy_times


def rates_lazy(torch):
    """lazy_epoch's device time per epoch through its public wrapper
    (``lazy_epoch_in_range``, CUDA events over 5 back-to-back VR epochs) on
    phase 5b's three timed problems, drawn as phase 5b draws them: the
    README shape, the uniform-74 stand-in and the rows of varying
    length."""
    import gc

    from repro_torch.kernels.lazy_epoch import kernel as lazy_kernel
    from repro_torch.prox import lazy

    gen = torch.Generator(device="cuda").manual_seed(4)
    n, d, nnz = RCV1
    shapes = (("README shape", 0.001, lambda: sparse_rows(
                  lazy, lazy.make_sparse_data(gen, 4096, 16384, 32))),
              ("uniform-74 stand-in", 1e-5, lambda: sparse_rows(
                  lazy, lazy.make_sparse_data(gen, n, d, nnz))),
              ("varying length", 1e-5, lambda: ragged_rows(torch, n, d)))
    out = []
    for label, l1, make in shapes:
        args, kw = lazy_epoch_args(torch, *make(), l1)
        (rows, w), T = args[0].shape, args[7].shape[0]
        ms = event_ms(torch, lambda: lazy_kernel.lazy_epoch_in_range(
            *args, **kw), calls=5)
        log(f"[rates] lazy_epoch {label} (n {rows}, d {args[4].shape[0]}, "
            f"width {w}): {ms!r} ms an epoch, {ms / T * 1e3!r} us a step")
        out.append(dict(label=label, ms=ms, per_step_ms=ms / T))
        del args
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_profile(torch):
    """Where each fused VR run of phases 4 and 5 spends its time: the
    run through ``solve`` untraced (wall), then again under
    ``torch.profiler``: device time, the device's busy share (device
    time over the untraced wall) and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import RunSpec, solve

    for label, spec, cfg, draws, _, steps, _, vr in (main_runs(torch)
                                                     + family_runs(torch)):
        if not vr:
            continue
        run = lambda: solve(RunSpec(fused=True, **spec), cfg,  # noqa: E731
                            orders=draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # device-side rows only (kernels, copies): an operator's row
        # repeats the device time of the kernels it launched
        rows = [(e.self_device_time_total, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        device_ms = sum(r[0] for r in rows) / 1e3
        log(f"[profile] {label}: {wall_ms:.3f} ms untraced, device "
            f"{device_ms:.3f} ms, busy share {device_ms / wall_ms:.3f}, "
            f"{wall_ms * 1e3 / steps:.4f} us per inner step, "
            f"{sum(r[1] for r in rows)} device ops")
        for t, count, key in rows[:6]:
            log(f"[profile]   {t / 1e3:10.3f} ms  {count:6d} x  {key[:80]}")


def phase_profile_lm(torch, label, cfg, tcfg, W, fused=True):
    """Where a full-width LM step's time goes: one warm epoch, then one
    epoch traced with ``torch.profiler``: device time per step, busy
    share, the kernels that take the device time, and the backward by
    autograd node."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import step as tstep

    run, meta = tstep.make_epoch_runner(cfg, tcfg, W, fused=fused)
    state = tstep.init_train_state(cfg, tcfg, W)
    state, _ = run(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run(state)
    torch.cuda.synchronize()
    steps = meta["comm_every"]
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = run(state)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / steps / 1e3
    log(f"[profile] {label} {'fused' if fused else 'unfused'}: "
        f"{wall_ms:.3f} ms/step untraced, "
        f"device {device_ms:.3f} ms/step, busy share "
        f"{device_ms / wall_ms:.3f}, device ops "
        f"{sum(r[1] for r in rows) / steps:.1f}/step")
    for t, count, key in rows[:16]:
        log(f"[profile]   {t / steps / 1e3:9.3f} ms/step  {count / steps:6.1f}"
            f"/step  {key[:90]}")
    # the backward by autograd node: the device time of the kernels each
    # node launched, its recompute under remat included (nodes overlap
    # where one runs inside another)
    nodes = sorted(((e.device_time_total, e.count, e.key)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU
                    and e.key.startswith("autograd::engine::evaluate")),
                   reverse=True)
    for t, count, key in nodes[:8]:
        log(f"[profile]   backward {t / steps / 1e3:9.3f} ms/step  "
            f"{count / steps:6.1f}/step  {key.split(': ')[-1][:70]}")
    del state, run
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--rates" in sys.argv[1:]:
        smi = phase_device(torch)
        log(f"[rates] repro_torch from {_src_dir()}")
        rates, kernel, lazy_times = phase_rates(torch)
        log(f"[card] {smi}")
        log(json.dumps({"rates": rates, "vr_epoch": kernel,
                        "lazy_epoch": lazy_times, "src": str(_src_dir())}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    import numpy as np

    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.vr_update import ref as vr_ref
    from repro_torch.models import model
    from repro_torch.prox import operators as proxops

    kernels = kernel_modules()
    vr_kernel, vr_epoch, rms_kernel, fa_kernel, ssd_kernel = (
        kernels[k] for k in ("vr_update", "vr_epoch", "rmsnorm",
                             "flash_attention", "ssd_scan"))
    t_start = time.perf_counter()
    smi = phase_device(torch)
    phase_build(kernels)
    if "--spmd" in sys.argv[1:]:
        spmd = phase_spmd(torch, kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"spmd": spmd}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--sparse" in sys.argv[1:]:
        sparse = phase_sparse(torch, kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"lazy_epoch": {k: sparse[k] for k in (
            "max_abs_err", "max_rel_err", "times", "runs")}}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    worst = phase_compare(torch, np, vr_kernel, vr_ref, proxops)
    vr_bf16_err = phase_compare_vr_bf16(torch, vr_kernel, vr_ref)
    epoch_err, epoch_rel = phase_compare_epoch(torch, vr_epoch, vr_ref,
                                               proxops)
    rms_err = phase_compare_rmsnorm(torch, rms_kernel, rms_ref)
    fa_err = phase_compare_flash(torch, fa_kernel, fa_ref)
    fa_repaired_err = phase_compare_flash_repaired(torch, fa_kernel, fa_ref)
    ssd_err = phase_compare_ssd(torch, ssd_kernel, ssd_ref)
    (full, _), (reduced, _) = lm_configs()
    lm_shape = vr_update_lm(torch, vr_kernel, vr_ref,
                            (1, model.ParamLayout(full).n), timed=True)
    lm_red_shape = vr_update_lm(torch, vr_kernel, vr_ref,
                                (2, model.ParamLayout(reduced).n),
                                timed=False)
    paths = phase_main_path(torch, kernels)
    paths += phase_family(torch, kernels)
    sparse = phase_sparse(torch, kernels)
    spmd = phase_spmd(torch, kernels)
    lm = phase_lm(torch, kernels)
    (mamba_full, _), _ = mamba_configs()
    mamba_shape = vr_update_lm(torch, vr_kernel, vr_ref,
                               (2, model.ParamLayout(mamba_full).n),
                               timed=True)
    epoch_times = [time_vr_epoch(torch, vr_epoch, vr_ref, *shape)
                   for shape in EPOCH_SHAPES]
    rms_time = time_rmsnorm(torch, rms_kernel, rms_ref)
    rms_mamba_time = time_rmsnorm(torch, rms_kernel, rms_ref, 8192, 768)
    fa_time = time_flash(torch, fa_kernel, fa_ref)
    fa_f32_time = time_flash(torch, fa_kernel, fa_ref, dtype="float32")
    fa_hd256_time = time_flash(torch, fa_kernel, fa_ref, H=10, KV=1, hd=256)
    ssd_time = time_ssd(torch, ssd_kernel, ssd_ref)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch)
        (qcfg, qtcfg), _ = lm_configs()
        phase_profile_lm(torch, "qwen2-7b width L=2 W=1", qcfg, qtcfg, 1)
        (mcfg, mtcfg), _ = mamba_configs()
        for fused in (True, False):
            phase_profile_lm(torch, "mamba2-130m L=24 W=2", mcfg, mtcfg, 2,
                             fused=fused)
    total = dict.fromkeys(kernels, 0)
    total["vr_epoch"] = sum(p["launches"] for p in paths)
    total["lazy_epoch"] = sum(r["launches"] for r in sparse["runs"])
    for run in lm:
        for name, n in run["counts"].items():
            total[name] += n
    for name, n in spmd["launches"].items():
        total[name] += n
    mamba = next(r for r in lm if r["label"].startswith("mamba2-130m L=24"))
    lm_paths = [{k: r[k] for k in ("label", "counts", "per_step", "steps",
                                   "steps_s", "unfused_steps_s",
                                   "peak_bytes",
                                   "unfused_peak_bytes", "loss_err",
                                   "update_err")} for r in lm]
    head = epoch_times[0]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(f"[card] {smi}")
    log(json.dumps({"kernels": [{
        "name": "vr_update", "route": "cuda",
        "source": "src/repro_torch/kernels/vr_update/csrc/vr_update.cu",
        "replaces": "src/repro/kernels/vr_update/kernel.py:64",
        "launches": total["vr_update"],
        "max_abs_err": lm_shape["max_abs_err"],
        **{k: lm_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "shape", "dtype")},
        "library_ms": None,
        "convex_shapes_max_abs_err": worst["float64"],
        "other_shapes": [lm_red_shape, mamba_shape],
        "bf16_lane_max_abs_err": vr_bf16_err, "paths": lm_paths}, {
        "name": "vr_epoch", "route": "cuda",
        "source": "src/repro_torch/kernels/vr_update/csrc/vr_epoch.cu",
        "replaces": "src/repro/kernels/vr_update/kernel.py:64",
        "launches": total["vr_epoch"], "max_abs_err": epoch_err,
        "max_rel_err": epoch_rel,
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "shape", "T", "lane", "dtype",
                                "per_step_ms", "plain_per_step_ms", "bytes",
                                "serial_floor_ms", "serial_floor_step_ms",
                                "paced_by", "bound_share")},
        "other_shapes": epoch_times[1:],
        "paths": [{k: p[k] for k in ("label", "launches", "k1_launches",
                                     "inner_steps", "inner_steps_s",
                                     "evals_per_round", "wall_s",
                                     "unfused_wall_s", "peak_bytes",
                                     "max_diff")}
                  for p in paths],
        "spmd_paths": spmd["runs"]}, {
        "name": "lazy_epoch", "route": "cuda",
        "source": "src/repro_torch/kernels/lazy_epoch/csrc/lazy_epoch.cu",
        "replaces": "src/repro/prox/lazy.py:215 (the jitted scan "
                    "_lazy_epoch; no Pallas kernel)",
        "launches": total["lazy_epoch"], "max_abs_err": sparse["max_abs_err"],
        "max_rel_err": sparse["max_rel_err"],
        **{k: sparse["times"][0][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "T", "dtype", "per_step_ms", "plain_per_step_ms", "bytes",
            "touched_bytes", "bound_share", "threads", "entries",
            "split_ms", "serial_floor_ms", "serial_floor_step_ms",
            "paced_by")},
        "other_shapes": sparse["times"][1:], "paths": sparse["runs"],
        "track_iterates": sparse["track"]}, {
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:21",
        "launches": total["rmsnorm"], "max_abs_err": rms_err[(1024, 3584)],
        **{k: rms_time[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape", "dtype",
                                    "eager_ms")},
        "other_shapes": [dict(rms_mamba_time,
                              max_abs_err=rms_err[(8192, 768)])]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:33",
        "launches": total["flash_attention"], "max_abs_err": fa_err,
        **{k: fa_time[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape", "dtype",
                                   "eager_ms", "tflops", "library_tflops",
                                   "bound_share")},
        "other_shapes": [dict(r, max_abs_err=fa_repaired_err[key])
                         for r, key in ((fa_f32_time, "float32_hd128"),
                                        (fa_hd256_time, "bfloat16_hd256"))]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:29",
        "launches": total["ssd_scan"], "max_abs_err": ssd_err,
        **{k: ssd_time[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape", "dtype",
                                    "eager_ms", "bound_3xtf32_ms",
                                    "bound_float32_ms", "bound_share",
                                    "launches_per_call")},
        "fused_peak_bytes": mamba["peak_bytes"],
        "unfused_peak_bytes": mamba["unfused_peak_bytes"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
