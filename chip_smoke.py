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
     bfloat16 (one rounding of a value below 4); K2 also at phase 9's
     examples' rows and widths (512 x 640, 128 x 128). K3 at the LM
     step's shape (S 1024, 28 query / 4 kv heads, hd 128), with a sliding
     window, S not a multiple of the block, H = KV, the reduced config's
     shape and phase 9's examples' (B 2: S 256, 10 / 2 heads, hd 64; S
     64, 4 / 2 heads, hd 32): error <= 2e-2 (bf16 output, float32 sums in
     another order); and K3 in float32 at the LM step's shape and in
     bfloat16 at hd 256 (recurrentgemma-2b's 10 / 1 heads, and its
     local blocks' S 4096 with window 2048): <= 1e-4 in float32, 2e-2
     in bf16. K1's bfloat16 lane (bf16 state, float32 g,
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
     ``dist-toy-logistic`` (n=5000 per worker, d=1000), 5 rounds, and
     CentralVR (Algorithm 1) on ``millionsong`` (n=46371, d=90), 2
     rounds (``MS_ROUNDS``: its unfused twin is the script's slowest
     run). vr_epoch must launch exactly once per fused epoch call (the
     init epoch and each round: 6 and 3) and K1 never; the trajectory
     must match the unfused run with the same visit orders to 1e-9;
     every rel must be finite and the last below the first;
  5. the rest of the convex family through ``repro_torch.solve``, each
     VR run fused and then unfused on the same draws: the paper's Fig. 1
     panel on ``toy-logistic`` (n 5000, d 20; CentralVR, SVRG with
     snapshot last, SAGA, SGD; 3 epochs) and §6.2's
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
     fused: CentralVR-Sync (5 rounds), CentralVR-Async round-robin and
     with speeds 1..8 (2 rounds), D-SVRG (tau 2*ns, 3 rounds), stale
     D-SAGA (tau 100, 20 rounds), distributed SGD, EASGD and PS-SVRG (2
     rounds each); CentralVR-Sync over NCCL at world = the card count
     (1 here, so p = 1) and Algorithm 1 on ``millionsong`` in a group of
     one rank; Mamba2-130M at full width, 4 of its 24 layers
     (``SPMD_LM_LAYERS``), W = 2, fused, over 2
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
     card they measure time-slicing and host staging, not scaling. The
     convex spawn, the NCCL spawn and the LM run at once, so their walls
     and the all-reduce probe are taken beside one another;
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
     3 more epochs (Mamba2-130M at full width 1, phase 6d's two widths
     2), each timed, for its steps/s (median, least, most).
     Then W=2 at ``qwen2-7b.reduced()``, fused against unfused, held the
     same way. Then Mamba2-130M at its full published width and depth (24
     SSD blocks, d 768, state 128, vocab 50280, tied head; 128,983,488
     parameters) at W=2, M=2, seq 2048, global batch 16, microbatch 4
     (A = 2), the same gates, with launches per step K1 1, K2
     (L + 1 + L) * A * W = 196, K4 (L + L) * A * W = 192; and W=2 at
     ``mamba2-130m.reduced()``;
 6d. the other block kinds and archs, each fused then unfused from the
     same seed through ``train.step.make_epoch_runner`` with the gates
     of phase 6 (losses finite, fused against unfused within 2**-7
     relative, the update on 2**20 sampled params within 5% in norm,
     exact launches per step, counted by layer kind by
     ``expected_launches``): qwen3-moe-30b-a3b's width cut to 2 layers
     (d 2048, 32 / 4 heads of 128, qk_norm, 128 experts, top 8,
     moe_d_ff 768, vocab 151936; 1,868,573,184 parameters) at seq 2048,
     and recurrentgemma-2b's width cut to 5 layers (rec, rec, local and
     the 2-layer rec tail; d 2560, 10 / 1 heads of 256, window 2048,
     RG-LRU 10 heads, vocab 256000, tied; 1,048,665,600 parameters) at
     seq 4096, both W 1, M 2, global batch 2, microbatch 1 (launches per
     step K1 1, K2 18 and 42, K3 8 and 4); then ``reduced()`` of each of
     the eight archs beyond Qwen2-7B and Mamba2-130M at W 2, seq 256,
     global batch 4, microbatch 1, 1 timed epoch each. ``--archs`` runs
     only the device phase, the build, phase 3's K3 cases in float32 and
     at hd 256 (recurrentgemma-2b's local shape among them), K1 at the
     MoE run's (1, 1,868,573,184) and this phase (with ``--profile``
     also the two full-width runs' profiles);
 6b. telemetry (``repro_torch.obs``): fused runs through ``solve`` on
     ``dist-toy-logistic`` (p 8, d 1000) of Algorithm 2 (5 rounds),
     Algorithm 3 with speeds 1..8 (2 rounds) and stale D-SAGA (tau 100,
     20 rounds), each unrecorded, recorded, unrecorded, recorded on the
     same draws: x and rels bit-identical, vr_epoch launches equal (and
     equal to the ``solve/<algo>/execute`` span's ``launches``), the
     span's ``device_ms`` <= its ``dur_s``, the streamed metric rows =
     rels, no CUDA event and no metric stream made unrecorded; ``[obs]``
     lines give the warm wall recorded against unrecorded. The
     ``kernels/build`` span of vr_epoch's source cold (a fresh
     ``--compile-cache`` directory) and from a second process on the
     same directory (it must compile nothing). ``python -m
     repro_torch.launch.solve --sweep --workers 8 --n 100 --d 1000
     --rounds 3`` (n cut from the preset's 5000 a worker so the unfused
     sweep under the profiler stays short) with ``--obs``, ``--json``
     and ``--profile``: exit 0, 11 provenance rows, the record validates
     (``launch.obs validate``), every execute span carries
     ``device_ms``, the trace parses (its kernel events counted); and
     ``python -m repro_torch.launch.train`` at Mamba2-130M's full width
     and depth (seq 2048, global batch 16, microbatch 4, W 2, M 2, one
     epoch) with ``--obs`` and ``--profile``, its ``train/epoch``,
     ``train_epoch`` and ``train/eval`` rows present. The second build,
     the sweep and the launcher run as three processes at once, after
     the timed runs. ``--obs`` runs only the device phase, the build and
     this phase;
 6c. the process fleet, elasticity and checkpoints on
     ``dist-toy-logistic`` (p 8, d 1000, float64; n cut from 5000 to
     1000 a worker for the lanes and the local elastic run):
     ``python -m repro_torch.launch.distributed --nprocs 2 --workers 8
     --x64 --verify`` (two processes of four workers on the card, their
     data plane a TCPStore served by process 0) in five lanes started
     together (in the full script, beside phase 6b's three processes):
     Algorithm 3 round-robin and with speeds 1..8 (2 rounds),
     Algorithm 2 (3 rounds), an exit fault of process 1 at round 2 (3
     rounds; the run goes on at p 4) and a stall of process 1 at round 1
     that rejoins at round 2 (3 rounds). Each lane exits 0 only if its
     trajectory equals the event-serial replay in its launcher bit for
     bit (Algorithm 2 within 1e-12); the transitions process 0 observed,
     ``detect_s`` at least the heartbeat timeout and valid records are
     checked here. Meanwhile, in this process: the local elastic run
     through ``solve`` (3 rounds, workers 0..3 at round 1, all 8 back at
     round 2) fused and unfused on the same draws, within 1e-9 relative,
     the fused run exactly one vr_epoch launch per event and per init
     epoch (21) and nothing else; an elastic checkpoint at round 2
     restored at p 4, continuing bit for bit as the run that drops there,
     and a SyncState round-trip; and Mamba2-130M at full width and depth
     (W 2, seq 2048, fused) through ``train.loop.run_training``: two
     epochs saving every epoch, then one epoch saved and resumed for
     epoch 2, whose losses and eval loss must equal the uninterrupted
     run's bit for bit (or, if two uninterrupted runs differ, lie within
     their spread), each run's launches a fused step's; save and restore
     seconds from the ``train/checkpoint`` and ``train/restore`` spans,
     the bytes a save writes. Files under ``build/fleet_smoke/``, the
     checkpoints deleted afterwards. ``--fleet`` runs only the device
     phase, the build and this phase;
  7. serving (``repro_torch.serve``): Qwen2-7B at its full width and
     depth (28 layers, 7,615,616,512 parameters drawn in float32 and
     cast once to bfloat16) on the paged engine (width 8, block 16,
     ``max_seq_len`` 640, prefill buckets 16 / 64 / 128) over 16
     requests (poisson arrivals, gap 4, prompts cycled over 128 / 256 /
     512 tokens, 64 new tokens cycled down to 16), which forces
     retirements and block reuse; the same trace on the dense oracle
     sharing the cast params; the one of its requests with the fewest
     new tokens served alone; a burst of
     4 requests (prompt 128, 16 new) on the engine and on
     ``run_host_loop`` at width 4, in bfloat16 (their ids compared and
     printed) and in float32 compute (gated). Gates: paged ids equal the
     dense ids and each request alone its ids in the batch, bit for bit;
     in float32 the prefill's first-token logits and the decode logits
     teacher-forced on the engine's ids within 2**-7 of their largest
     magnitude, and the legacy ids equal the engine's as far as the
     legacy top-2 margin exceeds that bound (printed); the decode step
     under ``kernel_ctx`` (K2 for every norm: 57 launches) within K2's
     bfloat16 tolerance (1e-2 of the largest logit) of the plain step;
     logits finite; every pool block free at the end. Then
     qwen3-moe-30b-a3b.reduced() on the engine (paged against dense),
     Mamba2-130M at full width and depth and recurrentgemma-2b.reduced()
     through the legacy loop (ids in the vocabulary; at float32 compute
     the per-token decode over the prompt against the forward's last
     logits within 2**-7). ``[serve]`` lines give prefill and decode tokens/s,
     p50 / p95 latency, the decode step's and a 128-token prefill
     chunk's device ms (CUDA events), the decode step's device ops
     (launches, one ``torch.profiler`` pass) and byte bound (weights and
     the gathered KV over 3.35 TB/s) with the share reached, first-call
     seconds per program, peak memory, KV-pool bytes and blocks reused;
     ``--profile`` adds the decode step's busy share and top operations.
     Lane 7b, tensor-parallel decode: Qwen2-7B at its full width and
     depth on the (data 1, model 2) mesh of 2 ranks sharing the card
     over gloo (``ServeEngine(mesh=...)``; each rank draws its shards
     from seed 0 one leaf at a time and casts them once), phase 7's burst
     in bfloat16 and in float32. Gates: the float32 burst's ids
     equal phase 7's float32 engine's, its prefill and every decode
     step's logits within 2**-7 of their largest magnitude; every
     request finished and every block free on both ranks; both ranks'
     ids equal; no kernel launched. Printed: how many bf16 requests
     equal phase 7's bf16 engine's ids, the decode step's device and wall ms, device
     ops, gloo bytes and collectives a rank, a 128-token chunk's ms,
     tokens/s, latency, peak memory a rank;
  8. the per-step runtime and the meshes (``train/host_loop.py``,
     ``make_train_step``, ``sharding/*``): 8a ``host_loop.run_training``
     on ``make_test_mesh()`` (one rank, (1, 1)) at the Qwen2-7B width, 2
     layers, seq 1024, A 2 microbatches of 2 rows, M 2, fused, 5 steps
     (a count the epoch runtime cannot take), bit for bit against two
     epochs of the epoch runner and one ``make_train_step`` step on its
     state, K1 / K2 / K3 counted per step; 8b the same config on the
     (data 2, model 2) mesh of 4 ranks sharing the card over gloo (FSDP
     over 'data', tensor parallelism over 'model'), 1 step, against that
     step on the (1, 1) mesh (losses within 2**-7, the sampled update
     within 5% in norm), every rank's K3 on 14 q heads and 2 kv heads, memory a
     rank, wall and gloo bytes and collectives a step; 8c
     ``qwen2-7b.reduced()`` in float32 with CentralVR workers on 'data'
     (W 2, ``dp_replicated``) and TP inside, against the vmap W 2 epoch
     runner (losses and params within LM_TOL), the worker spread above 0
     after a local step and exactly 0 at each epoch boundary; 8d
     expert parallelism: qwen3-moe-30b-a3b's width cut to 2 layers
     (1,868,573,184 params) with 8b's train config, first 1 step of
     ``make_train_step`` on the (1, 1) mesh, then 1 on (data 2, model 2)
     over 4 ranks (FSDP over 'data'; TP and the experts and router
     columns over 'model') against it by 8b's gates, every rank's K3 on
     16 q / 2 kv heads, 64 of the 128 experts of each layer a rank, K1
     once a step a rank. The single-device runs of 8b, 8c and 8d come
     first, then one spawn of 4 ranks runs 8b, 8c and 8d in turn.
     ``--mesh`` runs only the device phase, the build and this phase;
  9. the tooling (``launch/dryrun.py``, ``roofline/*``,
     ``repro_torch.examples``): lanes 8b and 8d (one
     ``make_train_step`` step of phase 8's configs) and 7b (one decode
     step of Qwen2-7B on (data 1, model 2) at phase 7's width and context)
     dry-run on meta tensors over the stand-in mesh
     (``launch.mesh.stand_in_mesh``), rank by rank; gated: collectives and
     bytes a step a rank and params a rank equal to the lanes' counts on
     the card in the same run (the full script) and to the counts the
     card gave for these lanes (``DRYRUN_LANES``); printed beside each lane's
     measured peak memory, the dry run's argument + temp bytes (plain
     attention and plain autograd, not the fused path: no gate). One
     production combo, ``qwen2-7b train_4k --mesh pod``, in a process of
     its own started after the build (phase 2), beside the card's phases:
     its record and its roofline line. The
     four examples on the card at their own sizes (quickstart;
     convex_distributed at p 8, n 1000 a worker, d 200, 12 rounds;
     serve_batched; train_centralvr_100m ``--full --steps 16`` without a
     checkpoint), each with
     its wall time and its kernels' launches; gated: launches above 0 of
     vr_epoch (quickstart, convex_distributed), K1 (quickstart), K2 and
     K3 (quickstart, train_centralvr_100m), CentralVR's final rel below
     SGD's (quickstart), the training loss falling (train), and the
     default profile of train_centralvr_100m (head_dim 40) refused by
     name before its first step. In the full script the examples run
     beside phase 8's ranks. ``--tooling`` runs only the device
     phase, the build, K2 and K3 against their plain versions (phase 3,
     which holds the examples' shapes) and this phase (gated against
     ``DRYRUN_LANES`` only: the lanes do not run);
 10. the ``kernels`` line: per kernel its launches on the main paths, its
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
     hd 256, without and with recurrentgemma-2b's window
     (``other_shapes``), K1 also at the MoE run's (1, 1,868,573,184);
     K1's ``paths`` the LM runs, phase 6d's included. vr_epoch per
     epoch and per step at each convex path's shape
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
width, Mamba2-130M, and Mamba2-130M unfused, the qwen3-moe-30b-a3b and
recurrentgemma-2b widths) with ``torch.profiler`` and
prints the device time, the device busy share against the same run
untraced, the kernels that take the device time, and the LM backward's
device time by autograd node.

``--sparse`` runs only the device phase, the build and phase 5b;
``--spmd`` only the device phase, the build and phase 4c; ``--fleet``
only the device phase, the build and phase 6c; ``--archs`` the device
phase, the build and phase 6d (see there); ``--serve`` the device
phase, the build and phase 7; ``--mesh`` the device phase, the build and
phase 8; ``--tooling`` the device phase, the build, K2's and K3's
comparisons and phase 9.

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
import atexit
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
# Algorithm 2's rounds (phases 4, 4c, 6b): cut from 10 (its unfused twin
# took 11.5 s) to keep the script in its time
ROUNDS = 5
# the Fig. 1 panel's epochs in phase 5: cut from 10 (their unfused twins
# took 33 s) and then 5 (18 s) to keep the script in its time
TOY_EPOCHS = 3
# millionsong's rounds in phase 4: cut from 10 so that its unfused twin
# (81.7-108.5 s at 10 rounds, 40.7 s at 3) leaves room in the script's time
MS_ROUNDS = 2
# RMSNorm: x*x, the sum, *r, *scale per element (float32 arithmetic)
RMS_OPS_PER_ELEMENT = 4
L2_BYTES = 50 * 2**20           # H100 L2
LM_EPOCHS = 2
# more epochs after the agreement check, timed (steps/s only, no gate),
# cut from 10 to keep the script in its time
LM_TIMING_EPOCHS = 3
# timed epochs of the slower full-width runs, cut from LM_TIMING_EPOCHS to
# keep the script in its time: Mamba2-130M (~3.1 s an epoch fused, ~4.1 s
# unfused; 4 before lanes 7b and 8d, 2 before phase 9) and phase 6d's two
# widths
MAMBA_TIMING_EPOCHS = 1
WIDE_TIMING_EPOCHS = 2
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
    main-path shapes (qwen3-moe's d 2048: 2048 rows in lane 8d's (1, 1)
    run and phase 6d, 1024 on each of 8d's ranks; phase 9's examples:
    train_centralvr_100m --full's 512 rows of d 640, quickstart's LM's
    128 rows of d 128)."""
    worst_at = {(1024, 3584): 0.0, (8192, 768): 0.0, (2048, 2048): 0.0,
                (1024, 2048): 0.0}
    g = torch.Generator(device="cuda").manual_seed(0)
    for rows, d, dt, sdt, off in (
            (1024, 3584, torch.bfloat16, torch.bfloat16, 0),
            (1024, 3584, torch.float32, torch.float32, 0),
            (8192, 768, torch.bfloat16, torch.bfloat16, 0),
            (2048, 2048, torch.bfloat16, torch.bfloat16, 0),
            (1024, 2048, torch.bfloat16, torch.bfloat16, 0),
            (512, 640, torch.bfloat16, torch.bfloat16, 0),
            (128, 128, torch.bfloat16, torch.bfloat16, 0),
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
    """K3 bf16 against its plain version at the main paths' shapes: the
    Qwen2 width (28 / 4 heads, and 14 / 2 a rank in lane 8b), qwen3-moe's
    group of 8 (32 / 4 heads at S 2048 in phase 6d and S 1024 in lane
    8d's (1, 1) run, 16 / 2 on each of 8d's ranks), phase 9's examples
    (train_centralvr_100m --full's group of 5, 10 / 2 heads at hd 64 and
    S 256; quickstart's LM at S 64, 4 / 2 heads, hd 32), and smaller and
    windowed cases; returns the error at the Qwen2 width."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(1)
    for B, S, H, KV, hd, win in ((1, 1024, 28, 4, 128, None),
                                 (1, 1024, 14, 2, 128, None),
                                 (1, 1024, 32, 4, 128, None),
                                 (1, 1024, 16, 2, 128, None),
                                 (1, 2048, 32, 4, 128, None),
                                 (1, 1024, 28, 4, 128, 200),
                                 (2, 200, 4, 2, 32, None),
                                 (1, 256, 4, 4, 64, None),
                                 (1, 1024, 4, 2, 32, None),
                                 (1, 100, 4, 2, 32, 16),
                                 (2, 200, 28, 4, 128, None),
                                 (2, 200, 28, 4, 64, None),
                                 (1, 2048, 28, 4, 128, None),
                                 (1, 2048, 28, 4, 128, 200),
                                 (2, 256, 10, 2, 64, None),
                                 (2, 64, 4, 2, 32, None)):
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
    """K3 in float32 at the Qwen2 slice's shape and in bfloat16 at hd 256,
    recurrentgemma-2b's local blocks (S 4096, 10 / 1 heads, window 2048)
    included; returns the largest error of each."""
    worst = {}
    g = torch.Generator(device="cuda").manual_seed(4)
    for B, S, H, KV, hd, win, dt, tol in (
            (1, 1024, 28, 4, 128, None, torch.float32, 1e-4),
            (1, 300, 4, 1, 256, 64, torch.float32, 1e-4),
            (1, 1024, 10, 1, 256, None, torch.bfloat16, 2e-2),
            (1, 200, 4, 2, 256, 16, torch.bfloat16, 2e-2),
            (1, 4096, 10, 1, 256, 2048, torch.bfloat16, 2e-2)):
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
        if (S, win) == (4096, 2048):        # recurrentgemma-2b's local blocks
            worst["bfloat16_hd256_local"] = err
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
         dict(algo="centralvr", rounds=MS_ROUNDS), ms,
         centralvr.draw_orders(gen, ms.n, MS_ROUNDS), MS_ROUNDS + 1,
         (MS_ROUNDS + 1) * ms.n, ms.n, True),
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
    CentralVR against SVRG (snapshot last), SAGA and SGD, TOY_EPOCHS
    each;
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
    n, E = toy.n, TOY_EPOCHS
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


def lm_run(torch, cfg, tcfg, W, fused, kernels, sample,
           timing_epochs=LM_TIMING_EPOCHS):
    """One LM run through the entry points a user calls: build the epoch
    runner and the state (seeded), then drive LM_EPOCHS epochs with every
    kernel's count set to 0 just before, and ``timing_epochs`` more, each
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
    for _ in range(timing_epochs):
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


def lm_pair(torch, cfg, tcfg, W, kernels, label,
            timing_epochs=LM_TIMING_EPOCHS):
    """The fused run and its unfused twin from the same seed, one after
    the other; checks finiteness, launches per step and agreement."""
    from repro_torch.models import model

    n = model.ParamLayout(cfg).n
    sample = torch.randint(0, n, (min(LM_SAMPLES, n),),
                           generator=torch.Generator().manual_seed(0)
                           ).to("cuda")
    f = lm_run(torch, cfg, tcfg, W, True, kernels, sample, timing_epochs)
    u = lm_run(torch, cfg, tcfg, W, False, kernels, sample, timing_epochs)
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
        log(f"[lm] {label}: {name} steps/s over {timing_epochs} epochs: "
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
    (A microbatches, W workers), counted by layer kind: the forward and
    the block's recompute each launch K2 for every block norm (one per
    ssm block, two per other block) when the arch's norm is RMSNorm
    (LayerNorm archs have none; qk_norm is plain), K3 once per attn or
    local block (a softcapped arch runs it plain) and K4 once per ssm
    block, plus K2 once for the final norm; K1 once; vr_epoch and
    lazy_epoch (the convex paths' kernels) never."""
    kinds = cfg.layer_kinds()
    norms = sum(1 if k == "ssm" else 2 for k in kinds)
    attn = sum(k in ("attn", "local") for k in kinds)
    if cfg.attn_logit_softcap is not None:
        attn = 0
    rms = cfg.norm_type == "rmsnorm"
    return {"vr_update": 1, "vr_epoch": 0, "lazy_epoch": 0,
            "rmsnorm": (2 * norms + 1) * A * W if rms else 0,
            "flash_attention": 2 * attn * A * W,
            "ssd_scan": 2 * kinds.count("ssm") * A * W}


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
                     "mamba2-130m L=24 W=2 S=2048",
                     timing_epochs=MAMBA_TIMING_EPOCHS),
             lm_pair(torch, mred, mtred, 2, kernels,
                     "mamba2-130m reduced W=2 S=256")]
    return runs


# ---------------------------------------------------------------------------
# Phase 6d: the other block kinds and archs
# ---------------------------------------------------------------------------

ARCHS_TIMING_EPOCHS = 1         # timed epochs of each reduced arch's run
LM_PATH_KEYS = ("label", "counts", "per_step", "steps", "steps_s",
                "unfused_steps_s", "peak_bytes", "unfused_peak_bytes",
                "loss_err", "update_err")   # an LM run in the result lines
NEW_ARCHS = ("internvl2-26b", "qwen3-14b", "musicgen-large",
             "qwen3-moe-30b-a3b", "starcoder2-15b", "recurrentgemma-2b",
             "qwen2-moe-a2.7b", "qwen1.5-110b")


def archs_configs():
    """The slice's full-width runs: qwen3-moe-30b-a3b's width cut to 2
    layers (seq 2048), and recurrentgemma-2b's width cut to 5 layers
    (one (rec, rec, local) super-block and the 2-layer rec tail the
    26-layer model ends with) at seq 4096, past its local window of
    2048; both W 1, M 2, global batch 2, microbatch 1 (A 2), SGD, remat
    "block"."""
    import dataclasses

    from repro_torch.config import TrainConfig, get_arch

    tcfg = TrainConfig(seq_len=2048, global_batch=2, microbatch=1,
                       learning_rate=1e-2, optimizer="sgd", vr="centralvr",
                       vr_table_size=2, local_epoch=1, remat="block", seed=0)
    moe = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), num_layers=2)
    rg = dataclasses.replace(get_arch("recurrentgemma-2b"), num_layers=5)
    return ((moe, tcfg, "qwen3-moe-30b-a3b width L=2 W=1 S=2048"),
            (rg, dataclasses.replace(tcfg, seq_len=4096),
             "recurrentgemma-2b width L=5 W=1 S=4096"))


def archs_reduced_tcfg():
    """W 2 at seq 256, global batch 4, microbatch 1, for each new arch's
    ``reduced()``."""
    from repro_torch.config import TrainConfig
    return TrainConfig(seq_len=256, global_batch=4, microbatch=1,
                       learning_rate=0.1, optimizer="sgd", vr="centralvr",
                       vr_table_size=2, local_epoch=1, remat="block", seed=0)


def phase_archs(torch, kernels):
    """Phase 6d: the MoE and RecurrentGemma widths, then every new arch's
    ``reduced()`` at W 2, each fused against unfused (``lm_pair``'s
    gates)."""
    from repro_torch.config import get_arch
    from repro_torch.models import model

    t0 = time.perf_counter()
    runs = []
    for cfg, tcfg, label in archs_configs():
        log(f"[lm] {label}: {model.ParamLayout(cfg).n} params, layer kinds "
            f"{list(cfg.layer_kinds())}")
        runs.append(lm_pair(torch, cfg, tcfg, 1, kernels, label,
                            timing_epochs=WIDE_TIMING_EPOCHS))
    tred = archs_reduced_tcfg()
    for name in NEW_ARCHS:
        runs.append(lm_pair(torch, get_arch(name).reduced(), tred, 2,
                            kernels, f"{name} reduced W=2 S=256",
                            timing_epochs=ARCHS_TIMING_EPOCHS))
    log(f"[path] phase 6d (archs) in {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# Phase 4c: the spmd backend, one worker per rank over torch.distributed
# ---------------------------------------------------------------------------

SPMD_TOL = 1e-9                 # against the vmap fused run, relative
# PS-SVRG's n per worker in phase 4c: each of its 2*n server steps a round
# waits for an all-reduce over gloo (505 of them took 12.3 s at n 125)
SPMD_PS_SVRG_N = 50
SPMD_PROBE_CALLS = 100          # all-reduces timed after the convex runs
# Mamba2-130M's layers in phase 4c's LM run: cut from its 24 (whose run
# over 2 ranks and its vmap twin took ~55 s), then from 8 (~32 s), to keep
# the script in its time
SPMD_LM_LAYERS = 4
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
    to ``world`` (the card count), ROUNDS rounds fused; and, in a group of
    one rank, Algorithm 1 on ``millionsong`` (ROUNDS epochs, fused)."""
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


def spmd_lm_configs():
    """Phase 4c's LM: Mamba2-130M's full width at SPMD_LM_LAYERS of its 24
    layers, with phase 6's training config."""
    import dataclasses
    (cfg, tcfg), _ = mamba_configs()
    return dataclasses.replace(cfg, num_layers=SPMD_LM_LAYERS), tcfg


def spmd_rank_lm(group, sample):
    """In a rank: phase 4c's LM (``spmd_lm_configs``), its worker of W = 2
    through ``make_epoch_runner(backend="spmd", fused=True)``, 2 epochs
    from the seeded state (``place_train_state``), counts set to 0 just
    before."""
    import torch

    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tcfg = spmd_lm_configs()
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
    """Phase 4c's LM (``spmd_lm_configs``) at W = 2 over 2 ranks sharing
    the card against the vmap W = 2 run from the same seed (its 2 epochs
    run here first, then freed): losses and the sampled params within
    LM_TOL, bit-identical across ranks, launches per step as a W = 1
    step's."""
    import gc

    from repro_torch.models import model
    from repro_torch.train import step as tstep

    cfg, tcfg = spmd_lm_configs()
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
    label = f"mamba2-130m L={SPMD_LM_LAYERS} W=2 S=2048"
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


def in_thread(fn, *args, **kw):
    """Start ``fn(*args, **kw)`` in a thread of its own; returns a
    function that waits for it and gives its result, or raises its
    error. For spawns whose ranks can run beside this process's work."""
    import threading

    out = {}

    def body():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:      # raised again in the waiter
            out["error"] = e

    thread = threading.Thread(target=body, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return wait


def phase_spmd(torch, kernels):
    """Phase 4c: the spmd backend on the card. The convex runs over 8
    ranks (``spawn_workers``; the transport that "auto" picks, gloo on
    one card), Algorithm 1 in a group of one rank, CentralVR-Sync over
    NCCL at world = the card count, and Mamba2-130M over 2 ranks; each
    held against the vmap run in this process on the same draws. On one
    card the convex spawn, the NCCL spawn and the LM (its vmap twin here,
    then its 2 ranks) run at once: their start-ups overlap, and the
    walls and the all-reduce probe are taken beside one another."""
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
    convex_ranks = in_thread(mesh.spawn_workers, p, spmd_rank_convex,
                             host[:len(convex)])
    if world == 1:
        nccl_ranks = in_thread(mesh.spawn_workers, 1, spmd_rank_convex,
                               host[-2:], transport="nccl")
    lm = spmd_lm(torch, mesh)
    ranks = convex_ranks()
    probe = [r.pop()["ms"] for r in ranks]
    log(f"[spmd] one all-reduce of a (1000,) float64 vector over {p} ranks "
        f"({ranks[0][0]['transport']}, staged through pinned host memory): "
        f"{max(probe)!r} ms (slowest rank's mean over {SPMD_PROBE_CALLS})")
    recs = spmd_check(torch, convex, vmap[:len(convex)], ranks)
    if world == 1:
        recs += spmd_check(torch, [sync, alg1], vmap[-2:],
                           [r[:-1] for r in nccl_ranks()])
    else:
        ranks = mesh.spawn_workers(world, spmd_rank_convex, host[-2:-1],
                                   transport="nccl")
        recs += spmd_check(torch, [sync], vmap[-2:-1],
                           [r[:-1] for r in ranks])
        ranks = mesh.spawn_workers(1, spmd_rank_convex, host[-1:])
        recs += spmd_check(torch, [alg1], vmap[-1:], [r[:-1] for r in ranks])
    recs.append(dict(label="all-reduce probe", world=p, ms=max(probe)))
    launches = {"vr_epoch": sum(sum(r[4]) for r in every)}
    for name, n in lm["counts"][0].items():
        launches[name] = launches.get(name, 0) + n * len(lm["counts"])
    log(f"[path] phase 4c (spmd) in {time.perf_counter() - t0:.1f} s")
    return dict(runs=recs, lm=lm, launches=launches)


# ---------------------------------------------------------------------------
# Phase 6b: telemetry (repro_torch.obs) and the command lines
# ---------------------------------------------------------------------------

OBS_OUT = ROOT / "build" / "obs_smoke"  # records and traces (build/ is
#                                         not committed)
# the CLI sweep's size: p 8 and d 1000 of dist-toy-logistic, its n cut to
# 100 a worker so the unfused sweep under the profiler stays short
OBS_SWEEP = ("--sweep", "--workers", "8", "--n", "100", "--d", "1000",
             "--rounds", "3")
# the train launcher at Mamba2-130M's full width and depth, W 2, M 2: one
# epoch (2 steps), whose profile alone is 0.75 million trace events
OBS_TRAIN = ("--arch", "mamba2-130m", "--seq-len", "2048",
             "--global-batch", "16", "--microbatch", "4", "--num-workers",
             "2", "--vr-table-size", "2", "--epochs", "1", "--optimizer",
             "sgd", "--lr", "0.01")


def obs_runs(torch):
    """Phase 6b's fused runs on ``dist-toy-logistic`` (p 8, 5000 x 1000 a
    worker) with their draws: (label, spec, draws, vr_epoch launches)."""
    from repro_torch.configs.paper_convex import PRESETS
    from repro_torch.core import distributed as ds

    gen = torch.Generator(device="cuda").manual_seed(6)
    dist = PRESETS["dist-toy-logistic"]
    p, ns = dist.workers, dist.n
    speeds = tuple(float(s) for s in range(1, p + 1))
    return dist, [
        ("centralvr_sync p=8", dict(algo="centralvr_sync", p=p,
                                    rounds=ROUNDS),
         ds.draw_sync_orders(gen, p, ns, ROUNDS), ROUNDS + 1),
        ("centralvr_async p=8 speeds 1..8",
         dict(algo="centralvr_async", p=p, rounds=2, speeds=speeds),
         ds.draw_async_orders(gen, p, ns, 2), 1 + 2 * p),
        ("dsaga p=8 stale (tau 100)",
         dict(algo="dsaga", p=p, rounds=20, tau=100, fetch="stale"),
         ds.draw_dsaga_orders(gen, p, ns, 20, 100), 20 * p),
    ]


def obs_solve(torch, kernels, spec_kw, cfg, draws, path=None):
    """One fused solve, recorded into ``path`` or not; returns (result,
    kernel counts, wall s, CUDA events and metric streams opened)."""
    from repro_torch import RunSpec, obs, solve
    from repro_torch.obs import stream

    made = {"events": 0, "streams": 0}
    event_cls, stream_cls = torch.cuda.Event, stream.MetricStream

    class CountedEvent(event_cls):
        def __new__(cls, *a, **kw):
            made["events"] += 1
            return event_cls.__new__(cls, *a, **kw)

    class CountedStream(stream_cls):
        def __init__(self, *a, **kw):
            made["streams"] += 1
            super().__init__(*a, **kw)

    torch.cuda.synchronize()
    reset_counts(kernels)
    torch.cuda.Event, stream.MetricStream = CountedEvent, CountedStream
    try:
        t0 = time.perf_counter()
        if path is None:
            res = solve(RunSpec(fused=True, **spec_kw), cfg, orders=draws)
        else:
            with obs.recording(str(path)):
                res = solve(RunSpec(fused=True, **spec_kw), cfg,
                            orders=draws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.Event, stream.MetricStream = event_cls, stream_cls
    return res, read_counts(kernels), wall, made


def obs_check_run(torch, kernels, label, spec_kw, cfg, draws, launches):
    """A fused run unrecorded, recorded, unrecorded, recorded on the same
    draws. Gates: x and rels bit-identical, the kernel counts equal and
    vr_epoch's = ``launches``, the execute span's launches equal them,
    device_ms <= dur_s, the metric rows = rels, no CUDA event and no
    stream made unrecorded. Returns the run's record."""
    import numpy as np

    from repro_torch.obs import schema

    algo = spec_kw["algo"]
    path = OBS_OUT / f"{algo}.jsonl"
    runs = [obs_solve(torch, kernels, spec_kw, cfg, draws,
                      path if i % 2 else None) for i in range(4)]
    off, on = runs[2], runs[3]
    want = dict.fromkeys(kernels, 0)
    want["vr_epoch"] = launches
    for res, counts, _, _ in runs:
        if not (np.array_equal(res.x, off[0].x)
                and np.array_equal(res.rels, off[0].rels)):
            raise AssertionError(f"[obs] {label}: a recorded run's x or "
                                 "rels differ from the unrecorded run's")
        if counts != want or res.launches["vr_epoch"] != launches:
            raise AssertionError(f"[obs] {label}: launched {counts}, "
                                 f"expected {want}")
    for _, _, _, made in runs[0::2]:
        if made != {"events": 0, "streams": 0}:
            raise AssertionError(f"[obs] {label}: the unrecorded run made "
                                 f"{made}")
    rows = schema.load_rows(str(path))
    schema.validate_rows(rows)
    spans = [r for r in rows if r["kind"] == "span"
             and r["name"] == f"solve/{algo}/execute"]
    if len(spans) != 1:
        raise AssertionError(f"[obs] {label}: {len(spans)} execute spans")
    ex = spans[0]
    if ex["launches"] != want:
        raise AssertionError(f"[obs] {label}: the execute span counted "
                             f"{ex['launches']}, the run {want}")
    if not 0.0 < ex["device_ms"] <= ex["dur_s"] * 1e3:
        raise AssertionError(f"[obs] {label}: device_ms {ex['device_ms']} "
                             f"against dur_s {ex['dur_s']}")
    metric = [r for r in rows if r["kind"] == "metric"]
    if ([r["value"] for r in metric] != [float(v) for v in on[0].rels]
            or [r["step"] for r in metric] != list(range(len(on[0].rels)))):
        raise AssertionError(f"[obs] {label}: metric rows differ from rels")
    names = {r["name"] for r in rows if r["kind"] == "event"}
    if not {"launches", "provenance"} <= names:
        raise AssertionError(f"[obs] {label}: events {names}")
    if on[3]["streams"] != 1:
        raise AssertionError(f"[obs] {label}: {on[3]['streams']} streams")
    log(f"[obs] {label}: warm wall recorded {on[2]!r} s against unrecorded "
        f"{off[2]!r} s (first pair {runs[1][2]!r} / {runs[0][2]!r} s); "
        f"execute span {ex['dur_s']!r} s, device_ms {ex['device_ms']!r}, "
        f"vr_epoch launches {launches}, {len(metric)} metric rows = rels, "
        f"{on[3]['events']} CUDA events made recorded, 0 unrecorded")
    return dict(label=label, launches=launches, wall_s=off[2],
                recorded_wall_s=on[2], first_wall_s=runs[0][2],
                first_recorded_wall_s=runs[1][2], span_dur_s=ex["dur_s"],
                device_ms=ex["device_ms"], metric_rows=len(metric))


def obs_split(torch, kernels, label, spec_kw, cfg, draws, reps=5):
    """Where a recorded run's extra wall goes: the run unrecorded,
    recorded, and recorded with the metric stream off (the span, the
    events and the rows kept), ``reps`` times each in turn; a
    ``[obs] split`` line with each one's median wall."""
    import statistics

    from repro_torch.obs import stream

    def no_stream(*args):
        return None

    walls = {"unrecorded": [], "recorded": [], "recorded, no stream": []}
    for i in range(reps):
        for kind in walls:
            path = None if kind == "unrecorded" else OBS_OUT / "split.jsonl"
            opened = stream.open_stream
            if kind == "recorded, no stream":
                stream.open_stream = no_stream
            try:
                walls[kind].append(obs_solve(torch, kernels, spec_kw, cfg,
                                             draws, path)[2])
            finally:
                stream.open_stream = opened
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[obs] split {label}: median wall of {reps} "
        + ", ".join(f"{k} {v!r} s" for k, v in med.items()))
    return med


def obs_row_cost(rows=200):
    """Seconds to write and flush one JSONL row (the recorder flushes
    every row), timed over ``rows`` metric rows into ``OBS_OUT``."""
    from repro_torch import obs

    with obs.recording(str(OBS_OUT / "rows.jsonl")) as rec:
        t0 = time.perf_counter()
        for i in range(rows):
            rec.metric("probe", i, 0.0)
        dt = (time.perf_counter() - t0) / rows
    log(f"[obs] one JSONL row written and flushed: {dt * 1e6:.1f} us "
        f"(mean of {rows})")
    return dt


def obs_build_cold(torch):
    """The kernels/build span cold: vr_epoch's source built under a
    recorder into a fresh --compile-cache directory. Returns the
    directory and the span."""
    import shutil

    from repro_torch import obs
    from repro_torch.kernels import build
    from repro_torch.kernels.vr_update import epoch as vr_epoch
    from repro_torch.launch.compile_cache import enable_compile_cache
    from repro_torch.obs import schema

    cache, path = OBS_OUT / "cc", OBS_OUT / "build.jsonl"
    shutil.rmtree(cache, ignore_errors=True)
    home = build.BUILD_DIR
    try:
        enable_compile_cache(str(cache))
        with obs.recording(str(path)):
            build.build(vr_epoch.SOURCE)
    finally:
        build.BUILD_DIR = home
    cold = [r for r in schema.load_rows(str(path))
            if r["name"] == "kernels/build"]
    if not (len(cold) == 1 and cold[0]["built"] == [vr_epoch.SOURCE.name]):
        raise AssertionError(f"[obs] cold kernels/build span: {cold}")
    return cache, cold[0]


# a second process on the cold build's directory: it must compile nothing
OBS_WARM_BUILD = (
    "import sys; from repro_torch import obs; "
    "from repro_torch.kernels import build; "
    "from repro_torch.kernels.vr_update import epoch; "
    "from repro_torch.launch.compile_cache import enable_compile_cache; "
    "enable_compile_cache(sys.argv[1]); obs.enable(sys.argv[2]); "
    "build.build(epoch.SOURCE); obs.disable()")


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_src_dir())] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def obs_start(label, argv, out_dir=OBS_OUT):
    """Start ``python argv...`` from the checkout's root, its output into
    ``out_dir/<label>.out``; returns (label, process, start time, output
    path)."""
    path = out_dir / f"{label}.out"
    with open(path, "w") as out:
        proc = subprocess.Popen([sys.executable, *argv], stdout=out,
                                stderr=subprocess.STDOUT, text=True,
                                env=_env(), cwd=str(ROOT))
    atexit.register(_stop, proc)
    return label, proc, time.perf_counter(), path


def obs_wait(job, timeout=600, tag="obs"):
    """Wait for a process of :func:`obs_start`; raises with its output's
    tail unless it exits 0. Returns its wall time."""
    label, proc, t0, path = job
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    tail = "\n".join(path.read_text().splitlines()[-14:])
    if proc.returncode != 0:
        raise AssertionError(f"[{tag}] {label} exited {proc.returncode}:\n"
                             f"{tail}")
    log(f"[{tag}] {label} in {wall:.1f} s:\n{tail}")
    return wall


def obs_trace(path):
    """(events, kernel events) of a torch.profiler Chrome trace: it must
    parse; kernel events show the profiler saw device time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return len(events), sum(e.get("cat") == "kernel" for e in events)


def obs_record(label, record, prof):
    """A launcher's record and traces: the record must pass ``launch.obs
    validate`` and every trace parse. Returns (rows, traces' (events,
    kernel events))."""
    from repro_torch.launch import obs as obs_cli_mod
    from repro_torch.obs import schema

    if obs_cli_mod.main(["validate", str(record)]) != 0:
        raise AssertionError(f"[obs] {label}: {record} does not validate")
    traces = [obs_trace(t) for t in sorted(prof.glob("trace-*.json"))]
    if not traces:
        raise AssertionError(f"[obs] {label}: no trace under {prof}")
    log(f"[obs] {label}: {len(traces)} trace(s), (events, kernel events) "
        f"{traces}")
    return schema.load_rows(str(record)), traces


def phase_obs(torch, kernels, beside=None):
    """Phase 6b: telemetry. Fused runs of Algorithms 2, 3 (speeds 1..8)
    and stale D-SAGA on ``dist-toy-logistic``, each unrecorded and
    recorded on the same draws (``obs_check_run``) and the cold
    kernels/build span, alone on the card; then three processes at once:
    a second build on the same --compile-cache directory, the solver's
    command line sweeping the registry with --obs, --json and --profile,
    and the train launcher at Mamba2-130M's full width with --obs and
    --profile. ``beside`` is called once these three have started (the
    full script starts phase 6c's launcher lanes there)."""
    import gc
    import shutil

    import numpy as np

    from repro_torch.obs import schema

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()        # the train launcher needs the card
    shutil.rmtree(OBS_OUT, ignore_errors=True)
    OBS_OUT.mkdir(parents=True)
    cfg, runs = obs_runs(torch)
    recs = [obs_check_run(torch, kernels, *run[:2], cfg, *run[2:])
            for run in runs]
    split = obs_split(torch, kernels, *runs[-1][:2], cfg, runs[-1][2])
    row_s = obs_row_cost()
    cache, cold = obs_build_cold(torch)

    warm_path = OBS_OUT / "build_warm.jsonl"
    sweep_json, sweep_rec = OBS_OUT / "sweep.json", OBS_OUT / "sweep.jsonl"
    train_rec = OBS_OUT / "train.jsonl"
    jobs = [obs_start("build-warm", ["-c", OBS_WARM_BUILD, str(cache),
                                     str(warm_path)]),
            obs_start("solve-sweep", [
                "-m", "repro_torch.launch.solve", *OBS_SWEEP, "--json",
                str(sweep_json), "--obs", str(sweep_rec), "--profile",
                str(OBS_OUT / "solve-sweep-prof")]),
            obs_start("train-mamba2", [
                "-m", "repro_torch.launch.train", *OBS_TRAIN, "--obs",
                str(train_rec), "--profile",
                str(OBS_OUT / "train-mamba2-prof")])]
    if beside is not None:
        beside()
    walls = [obs_wait(job) for job in jobs]

    warm = [r for r in schema.load_rows(str(warm_path))
            if r["name"] == "kernels/build"]
    if not (len(warm) == 1 and warm[0]["built"] == []
            and warm[0]["cached"] == 1):
        raise AssertionError(f"[obs] second process's kernels/build span: "
                             f"{warm}")
    log(f"[obs] kernels/build of vr_epoch.cu: cold {cold['dur_s']!r} s "
        f"(built {cold['built']}), a second process on the same "
        f"--compile-cache {warm[0]['dur_s']!r} s (built nothing, "
        f"{warm[0]['cached']} cached)")

    rows, traces = obs_record("solve-sweep", sweep_rec,
                              OBS_OUT / "solve-sweep-prof")
    with open(sweep_json) as f:
        prov = json.load(f)
    execute = [r for r in rows if r["kind"] == "span"
               and r["name"].endswith("/execute")]
    if not (len(prov) == 11 and len(execute) == 11
            and all(np.isfinite(r["final_rel"]) for r in prov)
            and all(r["device"] == torch.cuda.get_device_name(0)
                    for r in prov)
            and all(0.0 < r["device_ms"] <= r["dur_s"] * 1e3
                    for r in execute)):
        raise AssertionError(f"[obs] solve sweep: {len(prov)} rows, "
                             f"{len(execute)} execute spans")
    sweep = dict(wall_s=walls[1], traces=traces,
                 device_ms={r["name"]: r["device_ms"] for r in execute},
                 dur_s={r["name"]: r["dur_s"] for r in execute})

    rows, traces = obs_record("train-mamba2", train_rec,
                              OBS_OUT / "train-mamba2-prof")
    names = [r["name"] for r in rows]
    epochs = [r for r in rows if r["name"] == "train_epoch"]
    if not ("train/epoch/execute" in names and "train/eval" in names
            and "train_done" in names and len(epochs) == 1
            and all(np.isfinite(r["loss"]) for r in epochs)):
        raise AssertionError(f"[obs] train launcher record: {names}")
    first = next(r for r in rows if r["name"] == "train/epoch/execute")
    train = dict(wall_s=walls[2], traces=traces,
                 epoch_s=first["dur_s"], epoch_device_ms=first["device_ms"],
                 launches=first["launches"],
                 losses=[r["loss"] for r in epochs])
    log(f"[obs] train launcher: its epoch {first['dur_s']!r} s (device "
        f"{first['device_ms']!r} ms, launches {first['launches']}), "
        f"losses {train['losses']}")
    log(f"[path] phase 6b (obs) in {time.perf_counter() - t0:.1f} s")
    return dict(runs=recs, split=split, row_s=row_s, build=dict(cold_s=cold["dur_s"],
                                      warm_s=warm[0]["dur_s"]),
                sweep=sweep, train=train,
                launches=sum(4 * r["launches"] for r in recs))


# ---------------------------------------------------------------------------
# Phase 6c: the process fleet, elasticity and checkpoints
# ---------------------------------------------------------------------------

FLEET_OUT = ROOT / "build" / "fleet_smoke"  # records, logs, checkpoints
# dist-toy-logistic (logistic, d 1000, p 8, float64) over two processes
# of four workers on the card, through the launcher; an unfused event of
# 5000 steps took about 1 s on the card and --verify reruns every event in
# the launcher, so the rounds are cut (FLEET_LANES) and n a worker is cut
# from the preset's 5000 to FLEET_N (the lanes and the local elastic run
# took 90 s and 37 s at 5000)
FLEET_HB_S = 10.0               # the heartbeat wait, the launcher's default
FLEET_N = 1000
FLEET_SIZE = ("--nprocs", "2", "--workers", "8", "--n", str(FLEET_N),
              "--d", "1000", "--x64", "--verify", "--timeout", "600")
FLEET_SPEEDS = ",".join(str(s) for s in range(1, 9))
ALL_8 = list(range(8))
# (name, flags, transitions (round, live workers) process 0 must observe)
FLEET_LANES = (
    ("async-rr", ("--algo", "centralvr_async", "--rounds", "2"), []),
    ("async-speeds", ("--algo", "centralvr_async", "--rounds", "2",
                      "--speeds", FLEET_SPEEDS), []),
    ("sync", ("--algo", "centralvr_sync", "--rounds", "3"), []),
    ("exit", ("--algo", "centralvr_async", "--rounds", "3", "--elastic",
              "--drop-process", "1", "--drop-round", "2", "--drop-mode",
              "exit"), [(2, [0, 1, 2, 3])]),
    ("stall", ("--algo", "centralvr_async", "--rounds", "3", "--elastic",
               "--drop-process", "1", "--drop-round", "1", "--drop-mode",
               "stall", "--rejoin-after", "1"),
     [(1, [0, 1, 2, 3]), (2, ALL_8)]),
)
# the local elastic run: drop to workers 0..3 at round 1, all 8 back at 2
FLEET_PLAN = {1: (0, 1, 2, 3), 2: tuple(ALL_8)}
FLEET_PLAN_ROUNDS = 3
ELASTIC_TOL = 1e-9              # fused against unfused, relative


def fleet_lane(name, flags, want):
    """Check a finished launcher lane: exit 0 (its --verify held), the
    transitions process 0 observed, valid records; returns its record."""
    from repro_torch.obs import schema

    text = (FLEET_OUT / f"{name}.out").read_text()
    with open(FLEET_OUT / f"{name}.json") as f:
        res = json.load(f)
    verify = next(line for line in text.splitlines()
                  if line.startswith("verify: max"))
    fleet = next(line for line in text.splitlines()
                 if line.startswith("fleet ok"))
    diff = float(verify.split("= ")[1].split()[0])
    got = [(t["round"], t["live"]) for t in res["transitions"]]
    if got != want or "-> OK" not in verify or res["dropped"]:
        raise AssertionError(f"[fleet] {name}: transitions {got} (expected "
                             f"{want}), {verify}")
    rows = schema.load_rows(str(FLEET_OUT / f"{name}-p0.jsonl"))
    schema.validate_rows(rows)
    lost = [r for r in rows if r["name"] == "worker_lost"]
    joined = [r for r in rows if r["name"] == "worker_joined"]
    beats = [r["dur_s"] for r in rows if r["name"] == "elastic/heartbeat"]
    if "--elastic" in flags:
        if len(lost) != 4 or len(beats) != len(res["rels"]):
            raise AssertionError(f"[fleet] {name}: {len(lost)} worker_lost "
                                 f"rows, {len(beats)} heartbeat spans")
        if min(r["detect_s"] for r in lost) < FLEET_HB_S:
            raise AssertionError(f"[fleet] {name}: detect_s below the "
                                 "heartbeat timeout")
    if name == "exit":
        rows1 = schema.load_rows(str(FLEET_OUT / f"{name}-p1.jsonl"))
        if [(r["process"], r["round"]) for r in rows1
                if r["name"] == "fault_exit"] != [(1, 2)]:
            raise AssertionError("[fleet] exit: no fault_exit of process 1 "
                                 "at round 2")
    walls = fleet.split("processes' wall ")[1]
    rec = dict(name=name, rounds=len(res["rels"]), max_diff=diff,
               transitions=res["transitions"], device=res["device"],
               processes_wall_s=float(walls.split(" s")[0]),
               solve_wall_s=res["wall_s"],
               serial_wall_s=float(verify.split("took ")[1].split(" s")[0]),
               detect_s=[r["detect_s"] for r in lost],
               joined=len(joined), heartbeat_s=beats,
               final_rel=res["final_rel"])
    log(f"[fleet] {name}: rounds {rec['rounds']} ({' '.join(flags)}), "
        f"max|fleet - event-serial| {diff!r}, transitions {got}, "
        f"detect_s {rec['detect_s']}, heartbeat spans {beats}; the two "
        f"processes {rec['processes_wall_s']!r} s (process 0's solve "
        f"{rec['solve_wall_s']!r} s), the event-serial replay "
        f"{rec['serial_wall_s']!r} s, on {res['device']}")
    return rec


def fleet_elastic(torch, kernels, cfg):
    """The local elastic run through ``solve`` under FLEET_PLAN, fused and
    unfused on the same draws: x and rels within ELASTIC_TOL (relative),
    the fused run one vr_epoch launch per event and per init epoch and
    nothing else, the unfused run none."""
    from repro_torch import RunSpec, solve
    from repro_torch.core.elastic import PlannedMembership

    plan = PlannedMembership(8, FLEET_PLAN)
    events = sum(len(plan.live(r)) for r in range(FLEET_PLAN_ROUNDS))
    runs = {}
    for fused in (True, False):
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = solve(RunSpec(algo="centralvr_async", p=8,
                            rounds=FLEET_PLAN_ROUNDS, elastic=True,
                            fused=fused), cfg, membership=plan)
        torch.cuda.synchronize()
        runs[fused] = (res, read_counts(kernels),
                       time.perf_counter() - t0)
    (fres, fcounts, fwall), (ures, ucounts, uwall) = runs[True], runs[False]
    want = dict.fromkeys(kernels, 0)
    want["vr_epoch"] = 1 + events
    if fcounts != want or any(ucounts.values()):
        raise AssertionError(f"[fleet] elastic: fused launched {fcounts} "
                             f"(expected {want}), unfused {ucounts}")
    import numpy as np
    dx = float(np.abs(fres.x - ures.x).max() / np.abs(ures.x).max())
    drel = float(np.abs(fres.rels - ures.rels).max()
                 / np.abs(ures.rels).max())
    got = [(t["round"], t["live"]) for t in fres.transitions]
    if (dx > ELASTIC_TOL or drel > ELASTIC_TOL or got != [
            (1, [0, 1, 2, 3]), (2, ALL_8)]
            or fres.transitions != ures.transitions
            or not np.isfinite(fres.rels).all()):
        raise AssertionError(f"[fleet] elastic: |x| {dx}, |rels| {drel}, "
                             f"transitions {got}")
    log(f"[fleet] elastic (local, plan {FLEET_PLAN}, {FLEET_PLAN_ROUNDS} "
        f"rounds, {events} events): fused wall {fwall!r} s, unfused "
        f"{uwall!r} s, vr_epoch launches {fcounts['vr_epoch']} (1 + "
        f"{events} events), max |fused - unfused| x {dx!r}, rels {drel!r} "
        f"(relative); rels {fres.rels.tolist()}")
    return dict(events=events, launches=fcounts, wall_s=fwall,
                unfused_wall_s=uwall, max_dx=dx, max_drel=drel,
                rels=fres.rels.tolist())


def fleet_checkpoints(torch, cfg):
    """An elastic checkpoint at round 2 (p 8) restored at p 4 continues
    bit for bit as the run that drops to workers 0..3 there (fused); a
    fused Algorithm 2 run's SyncState round-trips bit for bit."""
    import os

    from repro_torch import RunSpec, solve
    from repro_torch.checkpoint import checkpoint
    from repro_torch.checkpoint import elastic as eckpt
    from repro_torch.core import convex, distributed, elastic

    sp = distributed.make_distributed(
        torch.Generator(device="cuda").manual_seed(cfg.seed), cfg)
    eta = convex.auto_eta(sp.merged())
    g0 = convex.grad_norm0(sp.merged())
    ckdir = FLEET_OUT / "elastic_ckpt"
    full = elastic.run_async_elastic(sp, eta=eta, rounds=4, fused=True,
                                     checkpoint_dir=str(ckdir),
                                     checkpoint_every=2)
    path = str(ckdir / "elastic_00002")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, man = eckpt.restore_elastic(path, 4)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _, cont = elastic.continue_async(elastic.reshard_problem(sp, 4), st,
                                     eta=eta, g0=g0, start_round=2, rounds=4,
                                     fused=True)
    drop = elastic.run_async_elastic(
        sp, eta=eta, rounds=4, fused=True,
        membership=elastic.PlannedMembership(8, {2: (0, 1, 2, 3)}))
    if not (man["round"] == 2 and man["p"] == 8
            and torch.equal(cont, drop.rels[2:])
            and torch.equal(full.rels[:2], drop.rels[:2])):
        raise AssertionError(f"[fleet] elastic checkpoint: continued "
                             f"{cont.tolist()}, the dropping run "
                             f"{drop.rels.tolist()}")
    ck_bytes = os.path.getsize(path + ".npz")

    res = solve(RunSpec(algo="centralvr_sync", p=8, rounds=2, fused=True),
                cfg)
    spath = str(FLEET_OUT / "sync_state.npz")
    t0 = time.perf_counter()
    s_bytes = checkpoint.save(spath, res.state, step=2)
    save_s = time.perf_counter() - t0
    back = checkpoint.restore(spath, res.state)
    if not (type(back) is type(res.state)
            and all(torch.equal(a, b) for a, b in zip(back, res.state))):
        raise AssertionError("[fleet] SyncState did not round-trip")
    log(f"[fleet] elastic checkpoint at round 2 (p 8, {ck_bytes} bytes) "
        f"restored at p 4 in {restore_s!r} s: the continuation equals the "
        f"run dropping to (0, 1, 2, 3) at round 2, bit for bit (rels "
        f"{cont.tolist()}); SyncState of Algorithm 2 (p 8, d 1000): "
        f"{s_bytes} bytes in {save_s!r} s, round-trips bit for bit")
    return dict(elastic_bytes=ck_bytes, elastic_restore_s=restore_s,
                sync_bytes=s_bytes, sync_save_s=save_s,
                rels=cont.tolist())


def fleet_lm(torch, kernels):
    """Mamba2-130M at full width and depth (W 2, seq 2048, fused) through
    ``train.loop.run_training``: two epochs saving every epoch (U); one
    epoch saving (B), then resumed from B's epoch-1 save for epoch 2
    (R). U's first epoch must equal B's, and R's losses and eval loss U's
    second epoch's and eval loss, bit for bit; if they do not, a second
    uninterrupted run (V) measures the run-to-run spread, which must be
    nonzero and bound R's difference. Each run's launches are gated to a
    fused step's. Save and restore seconds come from the
    ``train/checkpoint`` and ``train/restore`` spans."""
    import gc
    import os

    from repro_torch import obs
    from repro_torch.obs import schema
    from repro_torch.train import loop

    (cfg, tcfg), _ = mamba_configs()
    W, E = 2, tcfg.vr_table_size * tcfg.local_epoch
    per_step = expected_launches(cfg, 2, W)
    a, b = str(FLEET_OUT / "lm_a.npz"), str(FLEET_OUT / "lm_b.npz")
    record = str(FLEET_OUT / "lm.jsonl")

    def run(epochs, steps, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = loop.run_training(cfg, tcfg, epochs=epochs, workers=W,
                                fused=True, log_every=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(kernels)
        want = {k: v * steps for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"[fleet] LM launched {counts}, expected "
                                 f"{want}")
        out = dict(losses=res.losses, eval=res.final_eval_loss, wall_s=wall,
                   counts=counts)
        del res
        return out

    with obs.recording(record):
        u = run(2, 2 * E, checkpoint_path=a, checkpoint_every=1)
        a_bytes = os.path.getsize(a) + os.path.getsize(a + ".json")
        os.remove(a)
        bb = run(1, E, checkpoint_path=b, checkpoint_every=1)
        r = run(2, E, checkpoint_path=b, resume=True)
    os.remove(b)
    rows = schema.load_rows(record)
    saves = [x["dur_s"] for x in rows if x["name"] == "train/checkpoint"]
    restores = [x["dur_s"] for x in rows if x["name"] == "train/restore"]
    if len(saves) != 4 or len(restores) != 1:
        raise AssertionError(f"[fleet] LM: {len(saves)} save spans, "
                             f"{len(restores)} restore spans")
    first_same = bb["losses"] == u["losses"][:E]
    resumed_same = (r["losses"] == u["losses"][E:]
                    and r["eval"] == u["eval"])
    spread = None
    if not (first_same and resumed_same):
        v = run(2, 2 * E)
        spread = max(abs(x - y) for x, y in zip(
            v["losses"] + [v["eval"]], u["losses"] + [u["eval"]]))
        diff = max(abs(x - y) for x, y in zip(
            r["losses"] + [r["eval"]], u["losses"][E:] + [u["eval"]]))
        if not 0.0 < diff <= spread:
            raise AssertionError(
                f"[fleet] LM resume: |R - U| {diff!r} against the spread "
                f"{spread!r} of two uninterrupted runs")
    steps_launched = {k: u["counts"][k] + bb["counts"][k] + r["counts"][k]
                      for k in u["counts"]}
    log(f"[fleet] LM mamba2-130m L=24 W=2 S=2048 fused: resumed epoch 2 "
        f"{'bit-identical to' if spread is None else 'within the spread of'}"
        f" the uninterrupted run (losses {r['losses']}, eval "
        f"{r['eval']!r}; uninterrupted {u['losses']}, eval {u['eval']!r}"
        f"{'' if spread is None else f'; spread {spread!r}'}); a save "
        f"{a_bytes} bytes, saves {saves} s, restore {restores} s; walls "
        f"U {u['wall_s']!r} s (2 epochs, 2 saves), B {bb['wall_s']!r} s, "
        f"R {r['wall_s']!r} s; launches {steps_launched}")
    return dict(bit_identical=spread is None, spread=spread,
                save_bytes=a_bytes, save_s=saves, restore_s=restores,
                losses=u["losses"], resumed_losses=r["losses"],
                eval_loss=u["eval"], resumed_eval_loss=r["eval"],
                walls_s=[u["wall_s"], bb["wall_s"], r["wall_s"]],
                launches=steps_launched)


def fleet_start():
    """Phase 6c's five launcher lanes, started together as processes
    (``obs_start``); returns their jobs."""
    import shutil

    shutil.rmtree(FLEET_OUT, ignore_errors=True)
    FLEET_OUT.mkdir(parents=True)
    log(f"[fleet] cuts: n {FLEET_N} a worker (the preset's 5000); the lanes "
        "run rounds 2 (async round-robin, async speeds 1..8), 3 (sync; "
        "exit fault at round 2; stall at round 1, back at round 2) of the "
        f"{ROUNDS} the convex path runs; the local elastic run 3 rounds; "
        "the elastic checkpoint run 4 (n 5000); the LM 2 epochs of 2 steps")
    return [obs_start(name, [
        "-m", "repro_torch.launch.distributed", *FLEET_SIZE,
        "--hb-timeout", str(FLEET_HB_S), *flags,
        "--run-prefix", name, "--json", str(FLEET_OUT / f"{name}.json"),
        "--obs", str(FLEET_OUT / name), "--logdir",
        str(FLEET_OUT / f"{name}-logs")], FLEET_OUT)
        for name, flags, _ in FLEET_LANES]


def phase_fleet(torch, kernels, jobs=None):
    """Phase 6c: the launcher's five lanes at dist-toy-logistic's width
    (two processes of four workers each on the card, --verify), started
    together as processes (``fleet_start``; ``jobs``: already started,
    as the full script starts them beside phase 6b's processes);
    meanwhile, here, the local elastic run fused and unfused, the elastic
    and SyncState checkpoints and the Mamba2-130M checkpoint and resume.
    Returns the phase's record, its kernel launches by name under
    ``launches``."""
    import dataclasses
    import shutil

    from repro_torch.configs.paper_convex import PRESETS

    t0 = time.perf_counter()
    if jobs is None:
        jobs = fleet_start()
    cfg = PRESETS["dist-toy-logistic"]
    elastic_rec = fleet_elastic(torch, kernels,
                                dataclasses.replace(cfg, n=FLEET_N))
    ckpt_rec = fleet_checkpoints(torch, cfg)
    lm_rec = fleet_lm(torch, kernels)
    walls = [obs_wait(job, tag="fleet") for job in jobs]
    lanes = [dict(fleet_lane(name, flags, want), wall_s=wall)
             for (name, flags, want), wall in zip(FLEET_LANES, walls)]
    for name in ("lm_a.npz", "lm_b.npz", "sync_state.npz"):
        (FLEET_OUT / name).unlink(missing_ok=True)
    shutil.rmtree(FLEET_OUT / "elastic_ckpt", ignore_errors=True)
    launches = dict(lm_rec["launches"])
    launches["vr_epoch"] += elastic_rec["launches"]["vr_epoch"]
    log(f"[path] phase 6c (fleet) in {time.perf_counter() - t0:.1f} s")
    return dict(lanes=lanes, elastic=elastic_rec, checkpoints=ckpt_rec,
                lm=lm_rec, launches=launches)


# ---------------------------------------------------------------------------
# Phase 7: serving
# ---------------------------------------------------------------------------

# the paged engine's geometry and trace at Qwen2-7B's full width and depth
SERVE_GEO = dict(width=8, block_size=16, max_seq_len=640,
                 chunk_buckets=(16, 64, 128))
SERVE_REQUESTS = 16
SERVE_TRACE = dict(pattern="poisson", gap=4, prompt_lens=(128, 256, 512),
                   max_new=64, vary_new=True, seed=0)
SERVE_BURST = dict(pattern="burst", prompt_len=128, max_new=16, seed=1)
SERVE_BURST_N = 4
# requests served alone, the fewest new tokens first: cut from 3 to make room
# for lane 7b in the script's time
SERVE_ALONE = 1
SERVE_TOL = 2.0 ** -7           # engine against legacy, of the largest logit
K2_BF16_TOL = 1e-2              # K2's bf16 tolerance (phase 3)
SERVE_TIMED_STEPS = 20          # decode steps timed with CUDA events
SERVE_TIMED_CHUNKS = 5          # 128-token prefill chunks timed
# a decode step's lane lengths: every lane alive at its own position
SERVE_LENS = (130, 260, 515, 70, 300, 600, 17, 400)


def serve_ids(rep):
    return {r.rid: list(r.tokens) for r in rep.results}


def serve_report_line(label, rep):
    return serve_summary_line(label, rep.summary(), rep.compile_s)


def serve_summary_line(label, s, compile_s):
    log(f"[serve] {label}: {s['requests']} requests, {s['steps']} decode "
        f"steps; prefill {s['prefill_tokens']} tokens at "
        f"{s['prefill_tok_s']!r} tok/s; decode {s['decode_tokens']} tokens "
        f"at {s['decode_tok_s']!r} tok/s; latency p50 "
        f"{s['latency_p50_s']!r} s, p95 {s['latency_p95_s']!r} s; wall "
        f"{s['wall_s']!r} s; blocks reused {s['blocks_reused']}; first "
        f"calls {compile_s}")
    return s


def serve_rel_err(torch, got, want):
    """Largest difference over the largest magnitude of ``want``."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def serve_decode_inputs(torch, geo, vocab):
    """A decode step's inputs with every lane alive at its own length
    (``SERVE_LENS``), each lane on blocks of its own."""
    import numpy as np
    D, bps = geo.width, geo.blocks_per_seq
    tokens = np.arange(1, D + 1, dtype=np.int64) * 997 % vocab
    lens = np.array(SERVE_LENS[:D], np.int64)
    alive = np.ones(D, np.int64)
    tables = 1 + np.arange(D * bps, dtype=np.int64).reshape(D, bps)
    return tokens, lens, alive, tables


def serve_bytes(torch, eng, lens):
    """The decode step's byte bound: every weight it reads (the blocks in
    the compute dtype, the final norm and the head as they are; the
    embedding's rows are negligible) and the paged context it gathers,
    read once each (``lens`` does not change the gather: the tables map
    every lane's whole context)."""
    from repro_torch.models import model
    sizes = []
    model.tree_map(lambda t: sizes.append(t.numel() * t.element_size()),
                   [eng.params["layers"], eng.params["final_norm"],
                    eng.params["head"]])
    kv = sum(2 * eng.geo.width * eng.geo.context * t["k"].shape[2]
             * t["k"].shape[3] * t["k"].element_size() for t in eng.cache)
    return sum(sizes), kv


def serve_recorded(eng, reqs):
    """``reqs`` on the engine with each prefill chunk's logits and each
    decode step's logits of the first SERVE_BURST_N lanes recorded: (the
    report, {"prefill": [...], "decode": [...]})."""
    logs = {"prefill": [], "decode": []}
    prefill, decode = eng._prefill, eng._decode

    def rec_prefill(*a):
        out = prefill(*a)
        logs["prefill"].append(out[0].clone())
        return out

    def rec_decode(*a):
        out = decode(*a)
        logs["decode"].append(out[0][:SERVE_BURST_N].clone())
        return out
    eng._prefill, eng._decode = rec_prefill, rec_decode
    try:
        rep = eng.run(reqs)
    finally:
        eng._prefill, eng._decode = prefill, decode
    return rep, logs


def serve_burst(torch, eng, cfg, gate):
    """The burst on the engine with its prefill and decode logits
    recorded, then on ``run_host_loop`` at width 4. With ``gate`` (the
    float32 run) the legacy program also runs teacher-forced on the
    engine's ids (``train.step.make_serve_step``), and the gates: the
    prefill's first-token logits and the teacher-forced decode logits
    within SERVE_TOL of their largest magnitude, and the legacy ids equal
    to the engine's as far as the legacy top-2 margin exceeds that bound.
    Without (the bfloat16 run, where the two programs' roundings part
    them: 2.0% of the largest logit on an H100) the two runs' ids are
    compared and printed."""
    import numpy as np

    from repro_torch.models import model
    from repro_torch.serve import prompt_tokens, run_host_loop, synthetic_trace
    from repro_torch.train import step as tstep

    burst = synthetic_trace(SERVE_BURST_N, **SERVE_BURST)
    erep, logs = serve_recorded(eng, burst)
    tag = f"qwen2-7b {cfg.dtype} burst"
    serve_report_line(f"{tag}, engine", erep)
    lrep = run_host_loop(cfg, burst, params=eng.params, width=SERVE_BURST_N,
                         device="cuda")
    serve_report_line(f"{tag}, run_host_loop width 4", lrep)
    eids, lids = serve_ids(erep), serve_ids(lrep)
    same = sum(eids[r.rid] == lids[r.rid] for r in burst)
    out = dict(dtype=cfg.dtype, gated=gate, ids_equal=same,
               engine=erep.summary(), legacy=lrep.summary(),
               legacy_compile_s=lrep.compile_s)
    if not gate:
        log(f"[serve] {tag} engine against legacy: ids equal in full for "
            f"{same} of {len(burst)} requests (not gated)")
        return dict(out, _ids=eids)

    S, G = SERVE_BURST["prompt_len"], SERVE_BURST["max_new"]
    serve_step, _ = tstep.make_serve_step(cfg)
    prompts = torch.from_numpy(np.stack(
        [prompt_tokens(r, cfg.vocab_size) for r in burst]).astype(
        np.int64)).cuda()
    forced = torch.tensor([eids[r.rid] for r in burst], device="cuda")
    cache = model.init_cache(cfg, SERVE_BURST_N, S + G, device="cuda")
    for t in range(S):
        lg, cache = serve_step(eng.params, prompts[:, t:t + 1], cache, t)
    teacher = [lg]
    for g in range(1, G):
        lg, cache = serve_step(eng.params, forced[:, g - 1:g], cache,
                               S + g - 1)
        teacher.append(lg)
    del cache
    first_err = serve_rel_err(torch, torch.stack(logs["prefill"]),
                              teacher[0])
    step_errs = [serve_rel_err(torch, e, t)
                 for e, t in zip(logs["decode"], teacher[1:])]
    if len(logs["decode"]) != G - 1:
        raise AssertionError(f"[serve] burst: {len(logs['decode'])} decode "
                             f"steps recorded, expected {G - 1}")
    # how far the ids must agree: up to the first position where the
    # legacy top-2 margin is within the bound
    far = []
    for i, r in enumerate(burst):
        n = 0
        for g in range(G):
            row = teacher[g][i].float()
            top2 = torch.topk(row, 2).values
            if not float(top2[0] - top2[1]) > SERVE_TOL * float(
                    row.abs().max()):
                break
            n += 1
        far.append(n)
        if eids[r.rid][:n] != lids[r.rid][:n]:
            raise AssertionError(
                f"[serve] burst rid {r.rid}: engine ids {eids[r.rid]} and "
                f"legacy ids {lids[r.rid]} differ within the first {n}, "
                "whose legacy top-2 margins exceed the bound")
    log(f"[serve] {tag} engine against legacy: first-token logits "
        f"{first_err!r}, teacher-forced decode logits up to "
        f"{max(step_errs)!r} of the largest magnitude (bound {SERVE_TOL!r});"
        f" ids compared (legacy top-2 margin above the bound) for the first "
        f"{far} of {G} tokens, equal there; equal in full for "
        f"{sum(eids[r.rid] == lids[r.rid] for r in burst)} of "
        f"{len(burst)} requests" + ("" if gate else " (not gated)"))
    if gate and not (first_err <= SERVE_TOL
                     and max(step_errs) <= SERVE_TOL):
        raise AssertionError(f"[serve] burst: engine and legacy logits "
                             f"differ by {first_err}, {max(step_errs)}")
    return dict(out, first_logits_err=first_err,
                decode_logits_err=max(step_errs), ids_compared=far,
                _logs=dict(logs, ids=eids))


def serve_time(torch, eng, kernels, profile):
    """The decode step at SERVE_LENS and a 128-token prefill chunk, timed
    with CUDA events; one decode step under ``torch.profiler`` for its
    device ops (launches) and busy time; the step under ``kernel_ctx``
    (K2 for every norm) against the plain one, its launches counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.models import kernel_ctx

    geo = eng.geo
    ins = serve_decode_inputs(torch, geo, eng.cfg.vocab_size)
    from repro_torch.serve import runtime
    staged = runtime.stage(eng.device, *ins)

    def step():
        return eng._decode(eng.params, eng.cache, *staged)[0]

    plain = step()
    reset_counts(kernels)
    with kernel_ctx.scope():
        fused = step()
    torch.cuda.synchronize()
    k2 = read_counts(kernels)
    want = dict.fromkeys(kernels, 0)
    want["rmsnorm"] = 2 * eng.cfg.num_layers + 1
    k2_err = serve_rel_err(torch, fused, plain)
    log(f"[serve] decode step under kernel_ctx (K2 for every norm): "
        f"launches {k2} (expected {want}); logits against the plain step "
        f"{k2_err!r} of the largest magnitude (K2's bf16 tolerance "
        f"{K2_BF16_TOL!r}); finite {bool(torch.isfinite(fused).all())}")
    if k2 != want:
        raise AssertionError(f"[serve] kernel_ctx decode launched {k2}")
    if not k2_err <= K2_BF16_TOL or not bool(torch.isfinite(plain).all()):
        raise AssertionError(f"[serve] kernel_ctx decode differs by {k2_err}")

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(SERVE_TIMED_STEPS):
        step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED_STEPS
    decode_ms = start.elapsed_time(end) / SERVE_TIMED_STEPS

    row = staged[3][0]
    chunk = torch.arange(128, device=eng.device)

    def fill():
        return eng._prefill(eng.params, eng.cache, chunk, 0, 128, 0, row)[0]
    fill()
    torch.cuda.synchronize()
    start.record()
    for _ in range(SERVE_TIMED_CHUNKS):
        fill()
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end) / SERVE_TIMED_CHUNKS

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    launches = sum(r[1] for r in rows)
    busy_ms = sum(r[0] for r in rows) / 1e3
    weights, kv = serve_bytes(torch, eng, ins[1])
    bound_ms = (weights + kv) / PEAK_BYTES_S * 1e3
    log(f"[serve] qwen2-7b decode step (width {geo.width}, lanes at "
        f"{list(SERVE_LENS)}): {decode_ms!r} ms (CUDA events over "
        f"{SERVE_TIMED_STEPS} steps; host wall {wall_ms!r} ms); {launches} "
        f"device ops a step (torch.profiler); byte bound {bound_ms!r} ms "
        f"(weights {weights} + KV {kv} bytes at {PEAK_BYTES_S:.3g} B/s): "
        f"{bound_ms / decode_ms!r} of it reached")
    log(f"[serve] qwen2-7b prefill chunk of 128 tokens: {prefill_ms!r} ms "
        f"(CUDA events over {SERVE_TIMED_CHUNKS}); "
        f"{128e3 / prefill_ms!r} tokens/s")
    out = dict(decode_ms=decode_ms, decode_wall_ms=wall_ms,
               prefill_chunk_ms=prefill_ms, launches_per_step=launches,
               bound_ms=bound_ms, bound_share=bound_ms / decode_ms,
               weight_bytes=weights, kv_read_bytes=kv,
               kernel_ctx_max_rel_err=k2_err, k2_launches=k2["rmsnorm"])
    if profile:
        out["busy_ms"] = busy_ms
        out["busy_share"] = busy_ms / decode_ms
        log(f"[serve] decode step device busy {busy_ms!r} ms of "
            f"{decode_ms!r} ms: busy share {busy_ms / decode_ms!r}")
        for t, count, key in rows[:12]:
            log(f"[profile]   {t / 1e3:9.3f} ms  {count:5d} x  {key[:90]}")
    return out


def serve_small_engine(torch, name):
    """``name``.reduced() on the paged engine and on the dense oracle over
    one trace: ids equal, every block free at the end."""
    from repro_torch.config import get_arch
    from repro_torch.serve import ServeEngine, synthetic_trace

    cfg = get_arch(name).reduced()
    trace = synthetic_trace(6, pattern="uniform", prompt_len=24, max_new=8,
                            gap=2, vary_new=True, seed=2)
    kw = dict(width=4, block_size=8, max_seq_len=64, chunk_buckets=(8, 16),
              device="cuda", seed=0)
    ids = {}
    for mode in ("paged", "dense"):
        eng = ServeEngine(cfg, kv_cache=mode, **kw)
        eng.warmup()
        rep = eng.run(trace)
        serve_report_line(f"{name} reduced, {mode}", rep)
        ids[mode] = serve_ids(rep)
        if eng.allocator.in_use:
            raise AssertionError(f"[serve] {name}: {eng.allocator.in_use} "
                                 "blocks still in use")
    if ids["paged"] != ids["dense"]:
        raise AssertionError(f"[serve] {name}: paged ids {ids['paged']} "
                             f"!= dense {ids['dense']}")
    return dict(label=f"{name} reduced engine", steps=rep.steps,
                decode_tok_s=rep.decode_tok_s)


def serve_legacy_arch(torch, cfg, label, prompt_len, max_new):
    """``cfg`` through the legacy loop: a burst of 4 requests at width 4
    (ids in the vocabulary); then, at float32 compute on the same params,
    the per-token decode over the prompt against the full forward's last
    logits (``make_serve_step``'s pair), within SERVE_TOL of their
    largest magnitude (the reference's decode-against-forward oracle runs
    in float32 too)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import model
    from repro_torch.serve import prompt_tokens, run_host_loop, synthetic_trace
    from repro_torch.train import step as tstep

    params = model.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                               device="cuda")
    trace = synthetic_trace(4, pattern="burst", prompt_len=prompt_len,
                            max_new=max_new, seed=3)
    rep = run_host_loop(cfg, trace, params=params, width=4, device="cuda")
    serve_report_line(f"{label}, run_host_loop width 4", rep)
    ids = [t for r in rep.results for t in r.tokens]
    if not (len(ids) == 4 * max_new and 0 <= min(ids)
            and max(ids) < cfg.vocab_size):
        raise AssertionError(f"[serve] {label}: ids {ids}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    serve_step, serve_prefill = tstep.make_serve_step(cfg32)
    toks = torch.from_numpy(np.stack([prompt_tokens(r, cfg.vocab_size)
                                      for r in trace]).astype(np.int64)).cuda()
    full = serve_prefill(params, toks)
    cache = model.init_cache(cfg32, 4, prompt_len, device="cuda")
    for t in range(prompt_len):
        lg, cache = serve_step(params, toks[:, t:t + 1], cache, t)
    err = serve_rel_err(torch, lg, full)
    log(f"[serve] {label}: float32 per-token decode over the {prompt_len}-"
        f"token prompt against the forward's last logits: {err!r} of the "
        f"largest magnitude (bound {SERVE_TOL!r})")
    if not err <= SERVE_TOL or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"[serve] {label}: decode and forward differ "
                             f"by {err}")
    return dict(label=label, steps=rep.steps, decode_tok_s=rep.decode_tok_s,
                prefill_tok_s=rep.prefill_tok_s, decode_forward_err=err)


def phase_serve(torch, kernels, profile=False):
    """Phase 7: serving (``repro_torch.serve``). Qwen2-7B at its full width
    and depth (28 layers, float32 params cast once to bfloat16) on the
    paged engine over SERVE_TRACE, the same trace on the dense oracle
    sharing the cast params (ids bit for bit), SERVE_ALONE of its
    requests served alone (ids bit for bit), the burst on the engine and
    the legacy loop (``serve_burst``), the decode step timed and under
    ``kernel_ctx`` (``serve_time``), every pool block free at the end;
    then qwen3-moe-30b-a3b.reduced() on the engine, Mamba2-130M at full
    width and depth and recurrentgemma-2b.reduced() through the legacy
    loop; then lane 7b, tensor-parallel decode (``serve_tp``). Returns
    the phase's record; its K2 launches under ``launches``."""
    import dataclasses
    import gc

    from repro_torch.config import get_arch
    from repro_torch.models import model
    from repro_torch.serve import ServeEngine, synthetic_trace

    t_phase = time.perf_counter()
    cfg = get_arch("qwen2-7b")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                               device="cuda")
    n_params = model.param_count_actual(params)
    eng = ServeEngine(cfg, params, kv_cache="paged", device="cuda",
                      **SERVE_GEO)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pool = sum(t.numel() * t.element_size() for layer in eng.cache
               for t in layer.values())
    log(f"[serve] qwen2-7b: {n_params} params ({cfg.num_layers} layers), "
        f"float32 drawn and cast once to {cfg.dtype} in {init_s:.2f} s; KV "
        f"pool {eng.geo.num_blocks} blocks of {eng.geo.block_size}, "
        f"{pool} bytes; geometry {eng.geo}")
    compile_s = eng.warmup()
    trace = synthetic_trace(SERVE_REQUESTS, **SERVE_TRACE)
    reset_counts(kernels)
    rep = eng.run(trace)
    counts = read_counts(kernels)
    main = serve_report_line("qwen2-7b paged trace", rep)
    if any(counts.values()):
        raise AssertionError(f"[serve] the plain engine launched {counts}")
    if eng.allocator.in_use:
        raise AssertionError(f"[serve] {eng.allocator.in_use} blocks still "
                             "in use after the trace")
    if not rep.blocks_reused:
        raise AssertionError("[serve] the trace reused no block")
    ids = serve_ids(rep)

    dense = ServeEngine(cfg, eng.params, kv_cache="dense", device="cuda",
                        **SERVE_GEO)
    if dense.params["layers"][0]["mixer"]["wq"] is not \
            eng.params["layers"][0]["mixer"]["wq"]:
        raise AssertionError("[serve] the dense engine copied the params")
    dense.warmup()
    drep = dense.run(trace)
    serve_report_line("qwen2-7b dense trace", drep)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    if serve_ids(drep) != ids:
        raise AssertionError("[serve] paged and dense ids differ")
    alone_reqs = sorted(trace, key=lambda r: (r.max_new, r.rid))[:SERVE_ALONE]
    for r in alone_reqs:
        alone = eng.run([dataclasses.replace(r, arrival=0)])
        if serve_ids(alone)[r.rid] != ids[r.rid]:
            raise AssertionError(f"[serve] rid {r.rid} alone: "
                                 f"{serve_ids(alone)[r.rid]} != {ids[r.rid]}")
    log(f"[serve] paged ids equal the dense oracle's for all "
        f"{len(trace)} requests, and requests "
        f"{[r.rid for r in alone_reqs]} served alone equal their ids in the "
        "batch, bit for bit")
    burst = [serve_burst(torch, eng, cfg, gate=False)]
    ids_bf16 = burst[0].pop("_ids")
    timing = serve_time(torch, eng, kernels, profile)
    free = eng.allocator.available() == eng.geo.num_blocks - 1
    if eng.allocator.in_use or not free:
        raise AssertionError("[serve] pool blocks still held at the end")
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] qwen2-7b: peak memory {peak!r} bytes; every pool block "
        f"free at the end; first-call seconds {compile_s}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # engine against legacy, gated, at float32 compute: the same params
    # drawn again, no cast (the engine keeps the float32 masters)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = model.init_params(cfg32,
                               torch.Generator("cuda").manual_seed(0),
                               device="cuda")
    eng = ServeEngine(cfg32, params, kv_cache="paged", device="cuda",
                      **SERVE_GEO)
    del params
    burst.append(serve_burst(torch, eng, cfg32, gate=True))
    ref32 = burst[-1].pop("_logs")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    others = [serve_small_engine(torch, "qwen3-moe-30b-a3b")]
    others.append(serve_legacy_arch(torch, get_arch("mamba2-130m"),
                                    "mamba2-130m full width and depth", 64,
                                    16))
    others.append(serve_legacy_arch(torch,
                                    get_arch("recurrentgemma-2b").reduced(),
                                    "recurrentgemma-2b reduced", 40, 8))
    gc.collect()
    torch.cuda.empty_cache()
    tp = serve_tp(torch, ids_bf16, ref32)
    seconds = time.perf_counter() - t_phase
    log(f"[path] phase 7 (serve) in {seconds:.1f} s")
    return dict(qwen2_7b=dict(params=n_params, layers=cfg.num_layers,
                              init_s=init_s, pool_bytes=pool,
                              peak_bytes=peak, compile_s=compile_s,
                              trace=main, dense=drep.summary(), **timing,
                              burst=burst),
                others=others, tp=tp, seconds=seconds,
                launches={"rmsnorm": timing["k2_launches"]})


# ---------------------------------------------------------------------------
# Lane 7b: tensor-parallel decode
# ---------------------------------------------------------------------------

SERVE_TP = 2                    # lane 7b: (data 1, model 2), gloo on one card


def serve_tp_time(torch, eng, m):
    """In a rank of lane 7b: the decode step at SERVE_LENS (CUDA events
    and the host's wall over SERVE_TIMED_STEPS steps, the step's gloo
    bytes and collectives, its device ops under ``torch.profiler``) and a
    128-token prefill chunk (CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.serve import runtime

    ins = serve_decode_inputs(torch, eng.geo, eng.cfg.vocab_size)
    staged = runtime.stage(eng.device, *ins)

    def step():
        return eng._decode(eng.params, eng.cache, *staged)[0]

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    c0, b0 = m.collectives, m.carried_bytes
    t0 = time.perf_counter()
    start.record()
    for _ in range(SERVE_TIMED_STEPS):
        step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED_STEPS
    decode_ms = start.elapsed_time(end) / SERVE_TIMED_STEPS
    coll = (m.collectives - c0) / SERVE_TIMED_STEPS
    carried = (m.carried_bytes - b0) / SERVE_TIMED_STEPS
    row = staged[3][0]
    chunk = torch.arange(128, device=eng.device)

    def fill():
        return eng._prefill(eng.params, eng.cache, chunk, 0, 128, 0, row)[0]
    fill()
    torch.cuda.synchronize()
    start.record()
    for _ in range(SERVE_TIMED_CHUNKS):
        fill()
    end.record()
    torch.cuda.synchronize()
    prefill_ms = start.elapsed_time(end) / SERVE_TIMED_CHUNKS
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0)
    return dict(decode_ms=decode_ms, decode_wall_ms=wall_ms,
                prefill_chunk_ms=prefill_ms, launches_per_step=launches,
                collectives_per_step=coll, carried_bytes_per_step=carried)


def serve_tp_rank(group):
    """In a rank of lane 7b: Qwen2-7B at its full width and depth on the
    (data 1, model 2) mesh, the rank's shards drawn from seed 0 on the
    card one leaf at a time. The bf16 engine (cast once) over phase 7's
    burst (its 16-request trace took 46-66 s a rank over gloo, time the
    script cannot spare), then the decode step and a chunk timed
    (``serve_tp_time``); freed; then the float32 engine over the burst
    with its logits recorded (``serve_recorded``). Kernel counts set to
    0 before each run (the plain engine launches none)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.config import MeshConfig, get_arch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import model
    from repro_torch.serve import ServeEngine, synthetic_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = kernel_modules()
    m = meshlib.make_mesh(MeshConfig((1, SERVE_TP), ("data", "model")))
    cfg = get_arch("qwen2-7b")
    out = dict(coords=m.coords, transport=m.transport, device=str(m.device))
    for dtype in ("bf16", "float32"):
        c = cfg if dtype == "bf16" else dataclasses.replace(
            cfg, dtype="float32")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = ServeEngine(c, kv_cache="paged", mesh=m, seed=0, **SERVE_GEO)
        torch.cuda.synchronize()
        rec = dict(init_s=time.perf_counter() - t0,
                   params=model.param_count_actual(eng.params),
                   compile_s=eng.warmup())
        reset_counts(kernels)
        c0, b0 = m.collectives, m.carried_bytes
        reqs = synthetic_trace(SERVE_BURST_N, **SERVE_BURST)
        if dtype == "bf16":
            rep = eng.run(reqs)
        else:
            rep, logs = serve_recorded(eng, reqs)
            rec["logs"] = {k: [t.cpu() for t in v] for k, v in logs.items()}
        rec.update(counts=read_counts(kernels), ids=serve_ids(rep),
                   summary=rep.summary(),
                   collectives=m.collectives - c0,
                   carried_bytes=m.carried_bytes - b0,
                   finished=all(len(r.tokens) == r.max_new
                                for r in rep.results),
                   free=(eng.allocator.in_use == 0
                         and eng.allocator.available()
                         == eng.geo.num_blocks - 1))
        if dtype == "bf16":
            rec.update(serve_tp_time(torch, eng, m))
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        out[dtype] = rec
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_tp(torch, ids_bf16, ref32):
    """Lane 7b: SERVE_TP ranks sharing the card over gloo, against phase
    7's single-device engine: gated, the float32 burst's ids equal to
    phase 7's float32 engine's and its prefill and decode logits within
    SERVE_TOL of their largest magnitude, every request finished and
    every block free on every rank, both ranks' ids bit for bit, no
    kernel launched; printed, how many of the bf16 burst's requests
    equal phase 7's bf16 engine's ids (``ids_bf16``; not gated), the
    timings, gloo traffic and peak memory a rank."""
    from repro_torch.launch import mesh as meshlib

    t0 = time.perf_counter()
    ranks = meshlib.spawn_workers(SERVE_TP, serve_tp_rank)
    label = "qwen2-7b TP (data 1, model 2)"
    for r, rec in enumerate(ranks):
        for dtype in ("bf16", "float32"):
            x = rec[dtype]
            if not (x["finished"] and x["free"]):
                raise AssertionError(f"[serve] 7b: rank {r} {dtype}: "
                                     f"finished {x['finished']}, every "
                                     f"block free {x['free']}")
            if x["ids"] != ranks[0][dtype]["ids"]:
                raise AssertionError(f"[serve] 7b: rank {r}'s {dtype} ids "
                                     "differ from rank 0's")
            if any(x["counts"].values()):
                raise AssertionError(f"[serve] 7b: rank {r} launched "
                                     f"{x['counts']}")
    b16, f32 = ranks[0]["bf16"], ranks[0]["float32"]
    if f32["ids"] != ref32["ids"]:
        raise AssertionError(f"[serve] 7b: float32 TP ids {f32['ids']} != "
                             f"the single-device engine's {ref32['ids']}")
    got, want = f32["logs"], ref32
    if (len(got["decode"]) != len(want["decode"])
            or len(got["prefill"]) != len(want["prefill"])):
        raise AssertionError("[serve] 7b: the TP engine ran other programs "
                             "than the single-device one")
    first_err = max(serve_rel_err(torch, g, w.cpu()) for g, w in
                    zip(got["prefill"], want["prefill"]))
    step_err = max(serve_rel_err(torch, g, w.cpu()) for g, w in
                   zip(got["decode"], want["decode"]))
    agree = sum(b16["ids"][rid] == ids_bf16[rid] for rid in ids_bf16)
    for r, rec in enumerate(ranks):
        x = rec["bf16"]
        log(f"[serve] 7b {label}: rank {r} {rec['coords']} on "
            f"{rec['device']} ({rec['transport']}): {x['params']} params "
            f"(bf16), drawn and cast in {x['init_s']!r} s; peak memory "
            f"{x['peak_bytes']} bytes (bf16), {rec['float32']['peak_bytes']} "
            f"(float32 burst)")
    serve_summary_line(f"7b {label} bf16 burst", b16["summary"],
                       b16["compile_s"])
    serve_summary_line(f"7b {label} float32 burst", f32["summary"],
                       f32["compile_s"])
    log(f"[serve] 7b {label}: decode step at {list(SERVE_LENS)}: "
        f"{b16['decode_ms']!r} ms (CUDA events over {SERVE_TIMED_STEPS}; "
        f"host wall {b16['decode_wall_ms']!r} ms); "
        f"{b16['launches_per_step']} device ops a step a rank "
        f"(torch.profiler); {b16['collectives_per_step']!r} collectives and "
        f"{b16['carried_bytes_per_step']!r} gloo bytes a step a rank; "
        f"prefill chunk of 128 tokens {b16['prefill_chunk_ms']!r} ms")
    log(f"[serve] 7b {label}: float32 burst ids equal the single-device "
        f"engine's: True; prefill logits within {first_err!r}, decode "
        f"logits within {step_err!r} of the largest magnitude (bound "
        f"{SERVE_TOL!r}); both ranks' ids equal; bf16 burst ids equal "
        f"phase 7's for {agree} of {len(ids_bf16)} requests (not gated)")
    if not (first_err <= SERVE_TOL and step_err <= SERVE_TOL):
        raise AssertionError(f"[serve] 7b: TP and single-device logits "
                             f"differ by {first_err}, {step_err}")
    seconds = time.perf_counter() - t0
    log(f"[path] lane 7b (TP decode) in {seconds:.1f} s")
    keep = ("decode_ms", "decode_wall_ms", "prefill_chunk_ms",
            "launches_per_step", "collectives_per_step",
            "carried_bytes_per_step", "summary", "init_s", "params",
            "compile_s", "collectives", "carried_bytes")
    return dict(label=label, seconds=seconds, bf16_ids_equal=agree,
                first_logits_err=first_err, decode_logits_err=step_err,
                bf16={k: b16[k] for k in keep},
                float32={k: f32[k] for k in keep if k in f32},
                peak_bytes=[[r[d]["peak_bytes"] for d in ("bf16", "float32")]
                            for r in ranks], transport=ranks[0]["transport"])



# ---------------------------------------------------------------------------
# Phase 8: the per-step runtime and the 2-D data x model meshes
# ---------------------------------------------------------------------------

MESH_STEPS = 5                  # lane 8a: 2*M*K + 1, not a whole epoch count
# lane 8b: one step, cut from 4 and then 2 (its gloo steps took 13-28 s
# each) to keep the script in its time
MESH_FSDP_STEPS = 1
MESH_WORKER_STEPS = 4           # lane 8c
MESH_RANKS = 4                  # (data 2, model 2), sharing the card over gloo
# lane 8d: one step, cut from 3 and then 2 (18-31 s each over gloo) to keep
# the script in its time. 8b's and 8d's updates are a first step's, g
# uncorrected (the table and gbar start at zero); lane 8c (TP without
# FSDP) holds the VR correction with a filled table on a sharded mesh
MESH_MOE_STEPS = 1
# lane 8d's router (each layer's whole leaf) and expert leaves (sampled)
# against the (1, 1) run: bf16 rounding reroutes 5-10% of the token rows
# (a flipped token moves its whole contribution), so each leaf is held
# near the scale of a missing conjugate collective (30-70% on the CPU);
# with the routing pinned to the (1, 1) run's, at UPDATE_RTOL
MOE_LEAF_RTOL = 0.25


def mesh_configs():
    """Lanes 8a and 8b: the Qwen2-7B width at 2 layers, seq 1024, W 1,
    A 2 microbatches of 2 rows (one a data rank in 8b), CentralVR M 2,
    SGD. Lane 8c: ``qwen2-7b.reduced()`` in float32, W 2 on 'data' with
    ``dp_replicated``, A 2 of 2 rows, seq 256."""
    import dataclasses

    from repro_torch.config import TrainConfig, get_arch

    full = dataclasses.replace(get_arch("qwen2-7b"), num_layers=2)
    tcfg = TrainConfig(seq_len=1024, global_batch=4, microbatch=2,
                       learning_rate=1e-2, optimizer="sgd", vr="centralvr",
                       vr_table_size=2, local_epoch=1, remat="block", seed=0)
    red = dataclasses.replace(get_arch("qwen2-7b").reduced(),
                              dtype="float32")
    tred = dataclasses.replace(tcfg, seq_len=256, global_batch=8,
                               learning_rate=0.1, dp_replicated=True)
    return (full, tcfg), (red, tred)


def mesh_moe_config():
    """Lane 8d: qwen3-moe-30b-a3b's width cut to 2 layers, with lane 8b's
    train config (seq 1024, W 1, A 2 microbatches of 2 rows, M 2, SGD)."""
    import dataclasses

    from repro_torch.config import get_arch

    (_, tcfg), _ = mesh_configs()
    return dataclasses.replace(get_arch("qwen3-moe-30b-a3b"),
                               num_layers=2), tcfg


def mesh_lane(lane):
    """(config, train config, steps, label) of lane 8b or 8d."""
    if lane == "8b":
        (cfg, tcfg), _ = mesh_configs()
        return (cfg, tcfg, MESH_FSDP_STEPS,
                "qwen2-7b width L=2 (data 2, model 2) FSDP+TP")
    cfg, tcfg = mesh_moe_config()
    return (cfg, tcfg, MESH_MOE_STEPS, "qwen3-moe-30b-a3b width L=2 "
            "(data 2, model 2) FSDP+TP+experts")


def mesh_tokens(cfg, tcfg, W):
    """The run's token block (W, M*K, A, mb, S) on the host, the same in
    every process (the epoch runner's default)."""
    from repro_torch.data import synthetic
    from repro_torch.train import step as tstep

    accum, mb = tstep.batch_geometry(tcfg, W)
    return synthetic.epoch_tokens(cfg, tcfg.seed, workers=W, steps=2,
                                  accum=accum, microbatch=mb,
                                  seq=tcfg.seq_len, table_size=2)


def local_sample(torch, layout, flat, sample):
    """The entries of the full flat params at the indices ``sample`` that
    this rank's shards hold: (positions in ``sample``, values float64 on
    the host)."""
    pos, vals = [], []
    sample = sample.to(flat.device)
    for j, (full, sl) in enumerate(zip(layout.full.shapes, layout.slices)):
        o = layout.full.offsets[j]
        hit = ((sample >= o) & (sample < o + full.numel())).nonzero()[:, 0]
        if not len(hit):
            continue
        rem = sample[hit] - o
        coords = []
        for n in reversed(full):
            coords.append(rem % n)
            rem = rem // n
        coords = coords[::-1]
        inside = torch.ones_like(hit, dtype=torch.bool)
        local = torch.zeros_like(hit)
        for c, x, n in zip(coords, sl, layout.shapes[j]):
            inside &= (c >= x.start) & (c < x.stop)
            local = local * n + (c - x.start)
        pos.append(hit[inside])
        vals.append(flat[layout.offsets[j] + local[inside]])
    return (torch.cat(pos).cpu(), torch.cat(vals).double().cpu())


def mesh_single(torch, kernels):
    """Lane 8a: ``host_loop.run_training`` on ``make_test_mesh()`` (one
    rank, (1, 1)) for MESH_STEPS steps, fused, counts set to 0 just
    before; held bit for bit against the epoch runner's two epochs from
    the same seed followed by one ``make_train_step`` step on its state.
    Returns the record, with lane 8b's yardstick: the sampled params at
    step 0, and the losses and sampled params of MESH_FSDP_STEPS
    ``make_train_step`` steps on the (1, 1) mesh from the same seed."""
    import gc

    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import model
    from repro_torch.train import host_loop
    from repro_torch.train import step as tstep

    (cfg, tcfg), _ = mesh_configs()
    n = model.ParamLayout(cfg).n
    sample = torch.randint(0, n, (min(LM_SAMPLES, n),),
                           generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    run, _ = tstep.make_epoch_runner(cfg, tcfg, 1, fused=True)
    state = tstep.init_train_state(cfg, tcfg, 1)
    idx = sample.to(state.params.device)
    p0 = state.params[0, idx].double().cpu()
    losses = []
    for e in range(2):
        state, ls = run(state)
        losses.append(ls)
    epoch_losses = torch.cat(losses).tolist()
    step, _ = tstep.make_train_step(cfg, tcfg, meshlib.make_test_mesh(),
                                    fused=True)
    toks = mesh_tokens(cfg, tcfg, 1)
    for s in range(len(epoch_losses), MESH_STEPS):
        state, out = step(state, toks[0, s % 2])
        epoch_losses.append(float(out["loss"]))
    want = state.params.cpu()
    del state
    state = tstep.init_train_state(cfg, tcfg, 1)
    yard = []
    for s in range(MESH_FSDP_STEPS):
        state, out = step(state, toks[0, s % 2])
        yard.append(float(out["loss"]))
    p_end = state.params[0, idx].double().cpu()
    del state, run, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(kernels)
    res = host_loop.run_training(cfg, tcfg, steps=MESH_STEPS,
                                 mesh=meshlib.make_test_mesh(), fused=True,
                                 log_every=0)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    same_params = torch.equal(res.state.params, want.to(
        res.state.params.device))
    del res.state, want
    gc.collect()
    torch.cuda.empty_cache()
    expect = {k: v * MESH_STEPS
              for k, v in expected_launches(cfg, 2, 1).items()}
    label = "qwen2-7b width L=2 (1, 1) mesh, host loop"
    log(f"[mesh] 8a {label}: losses {res.losses} (epoch runner + one step "
        f"{epoch_losses}); params equal bit for bit: {same_params}")
    log(f"[mesh] 8a {label}: {MESH_STEPS} steps in {res.wall_time!r} s, "
        f"{MESH_STEPS / res.wall_time!r} steps/s; peak memory {peak} bytes; "
        f"launches {counts} (expected {expect})")
    if res.losses != epoch_losses or not same_params:
        raise AssertionError(f"[mesh] 8a: the host loop differs from the "
                             f"epoch runner: losses {res.losses} against "
                             f"{epoch_losses}, params equal {same_params}")
    if counts != expect:
        raise AssertionError(f"[mesh] 8a: launches {counts}, expected "
                             f"{expect}")
    return dict(label=label, losses=res.losses, steps=MESH_STEPS,
                wall_s=res.wall_time, steps_s=MESH_STEPS / res.wall_time,
                peak_bytes=peak, counts=counts, eval_loss=res.final_eval_loss,
                epoch_losses=yard, p0=p0, p_end=p_end,
                sample=sample.numpy())


def routing_spy(torch, replay=None):
    """Records, at every ``moe._top_k`` call (the forward and the
    backward's recomputation), the layer and each token's top-k experts
    (int16, on the host); returns (records, undo). With ``replay`` (an
    earlier run's records), the i-th call takes the i-th record's experts
    instead of its own, with their probabilities."""
    from repro_torch.models import moe, transformer

    stack, block, top_k = (transformer.apply_stack_train,
                           transformer.apply_block_train, moe._top_k)
    layer_of, now, recs = {}, [None], []

    def spy_stack(layers_p, *a, **kw):
        layer_of.update({id(lp): i for i, lp in enumerate(layers_p)})
        return stack(layers_p, *a, **kw)

    def spy_block(lp, *a, **kw):
        now[0] = layer_of.get(id(lp))
        return block(lp, *a, **kw)

    def spy_top_k(probs, k):
        vals, idx = top_k(probs, k)
        if replay is not None:
            idx = replay[len(recs)][1].to(idx.device, torch.int64)
            vals = probs.gather(1, idx)
        recs.append((now[0], idx.to(torch.int16).cpu()))
        return vals, idx

    transformer.apply_stack_train = spy_stack
    transformer.apply_block_train = spy_block
    moe._top_k = spy_top_k

    def undo():
        transformer.apply_stack_train = stack
        transformer.apply_block_train = block
        moe._top_k = top_k
    return recs, undo


def router_leaves(layout, flat):
    """Each layer's router as this rank holds it: (its slices of the full
    leaf, its values float64 on the host)."""
    return [(sl, flat[o:o + shp.numel()].view(shp).double().cpu())
            for path, o, shp, sl in zip(layout.paths, layout.offsets,
                                         layout.shapes, layout.slices)
            if path.endswith("ffn/router")]


def mesh_rank_fsdp(group, sample, lane="8b", replay=None):
    """In a rank of lane 8b or 8d: ``make_train_step`` on the (data 2,
    model 2) mesh, FSDP over 'data' and TP (and 8d's experts) over
    'model', the lane's fused steps from the seeded state, counts set to
    0 just before; K3's q / kv shapes recorded at each launch, and the
    experts the rank holds in each layer."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import mesh as meshlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, tcfg, steps, _ = mesh_lane(lane)
    m = meshlib.make_test_mesh()
    shapes = set()
    launch = fa_kernel.flash_attention

    def spy(q, k, v, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return launch(q, k, v, **kw)
    fa_kernel.flash_attention = spy
    recs, undo = routing_spy(torch, replay) if cfg.is_moe else ([], None)
    try:
        return _mesh_rank_fsdp(torch, m, cfg, tcfg, steps, sample, shapes,
                               recs)
    finally:
        fa_kernel.flash_attention = launch
        if undo is not None:
            undo()


def _mesh_rank_fsdp(torch, m, cfg, tcfg, steps, sample, shapes, recs):
    from repro_torch.train import step as tstep

    step, meta = tstep.make_train_step(cfg, tcfg, m, fused=True)
    pl = meta["placement"]
    state = tstep.init_train_state(cfg, tcfg, 1, mesh=m)
    sample = torch.from_numpy(sample)
    p0 = local_sample(torch, pl.layout, state.params[0], sample)
    r0 = router_leaves(pl.layout, state.params[0])
    toks = mesh_tokens(cfg, tcfg, 1)
    kernels = kernel_modules()
    marks = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(kernels)
    c0, b0 = m.collectives, m.carried_bytes
    losses, step_s = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, toks[0, s % 2])
        losses.append(float(out["loss"]))
        step_s.append(time.perf_counter() - t0)
        marks.append(len(recs))
    counts = read_counts(kernels)
    p_end = local_sample(torch, pl.layout, state.params[0], sample)
    r_end = router_leaves(pl.layout, state.params[0])
    experts = [shp[0] for path, shp in zip(pl.layout.paths, pl.layout.shapes)
               if path.endswith("ffn/wg") and cfg.is_moe]
    return dict(losses=losses, step_s=step_s, counts=counts,
                peak_bytes=torch.cuda.max_memory_allocated(),
                local_n=pl.layout.n, full_n=pl.layout.full.n,
                collectives=(m.collectives - c0) / steps,
                carried_bytes=(m.carried_bytes - b0) / steps,
                k3=sorted(shapes), transport=m.transport, coords=m.coords,
                device=str(m.device), p0=p0, p_end=p_end, experts=experts,
                routing=recs, marks=marks, router0=r0, router_end=r_end)


def mesh_rank_lanes(group, samples):
    """In a rank of phase 8's one spawn: lanes 8b, 8c and 8d in turn
    (``mesh_rank_fsdp``, ``mesh_rank_workers``), each freed before the
    next, one start-up for the three; each lane's record with its wall
    in the rank."""
    import gc

    import torch

    out = {}
    for lane in ("8b", "8c", "8d"):
        t0 = time.perf_counter()
        out[lane] = (mesh_rank_workers(group) if lane == "8c" else
                     mesh_rank_fsdp(group, samples[lane], lane))
        gc.collect()
        torch.cuda.empty_cache()
        out[lane]["wall_s"] = time.perf_counter() - t0
    return out


def mesh_fsdp_check(torch, single, ranks, lane="8b", replay=None):
    """Lane 8b or 8d: MESH_RANKS ranks on the card, each with its shards,
    against the lane's single-device run of the same seed and tokens
    (``mesh_single``'s yardstick, or ``mesh_moe_single``'s): losses
    within LOSS_RTOL (relative), the sampled params' update within
    UPDATE_RTOL in norm, every rank's K3 on its heads (8b: 14 q / 2 kv
    of 28 / 4; 8d: 16 q / 2 kv of 32 / 4), launches per step as the
    single-device step's (K1 once), and in 8d 64 of the 128 experts of
    each layer a rank. With ``replay`` (8d), every rank routed as the
    (1, 1) run did (``routing_spy``)."""
    cfg, _, steps, label = mesh_lane(lane)
    if replay is not None:
        label += ", routing pinned to the (1, 1) run's"
    want_losses = torch.tensor(single["epoch_losses"][:steps],
                               dtype=torch.float64)
    expect = {k: v * steps for k, v in expected_launches(cfg, 2, 1).items()}
    # one row of 1024 a rank; the q heads split over 'model', each rank
    # reading the kv heads its q heads read
    hq, kv = cfg.padded_heads // 2, cfg.num_kv_heads // 2
    k3 = [((1, 1024, hq, cfg.head_dim), (1, 1024, kv, cfg.head_dim))]
    experts = ([cfg.num_experts // 2] * cfg.num_layers if cfg.is_moe
               else [])
    n = len(single["sample"])
    got0 = torch.full((n,), float("nan"), dtype=torch.float64)
    got_end = got0.clone()
    for r, rec in enumerate(ranks):
        for dst, (pos, vals) in ((got0, rec["p0"]),
                                 (got_end, rec["p_end"])):
            seen = ~torch.isnan(dst[pos])
            if not torch.equal(dst[pos][seen], vals[seen]):
                raise AssertionError(f"[mesh] {lane}: rank {r}'s replicated "
                                     "params differ from another rank's")
            dst[pos] = vals
        if rec["counts"] != expect:
            raise AssertionError(f"[mesh] {lane}: rank {r} launched "
                                 f"{rec['counts']}, expected {expect}")
        if [tuple(map(tuple, x)) for x in rec["k3"]] != k3:
            raise AssertionError(f"[mesh] {lane}: rank {r} launched K3 at "
                                 f"{rec['k3']}, expected {k3}")
        if rec["experts"] != experts:
            raise AssertionError(f"[mesh] {lane}: rank {r} holds "
                                 f"{rec['experts']} experts a layer, "
                                 f"expected {experts}")
        if rec["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"[mesh] {lane}: rank {r}'s losses differ")
    if bool(torch.isnan(got0).any() | torch.isnan(got_end).any()):
        raise AssertionError(f"[mesh] {lane}: sampled params no rank holds")
    losses = torch.tensor(ranks[0]["losses"], dtype=torch.float64)
    loss_err = float(((losses - want_losses).abs()
                      / want_losses.abs()).max())
    want_delta = single["p_end"] - single["p0"]
    if not (torch.equal(got0, single["p0"])):
        raise AssertionError(f"[mesh] {lane}: the sharded init differs from "
                             "the single-device one")
    upd_err = float(((got_end - got0) - want_delta).norm()
                    / want_delta.norm())
    leaves = leaf_gaps(torch, cfg, single["sample"], (got_end - got0)
                       - want_delta, want_delta)
    for r, rec in enumerate(ranks):
        log(f"[mesh] {lane} {label}: rank {r} {rec['coords']} on "
            f"{rec['device']} ({rec['transport']}): {rec['local_n']} of "
            f"{rec['full_n']} params, peak memory {rec['peak_bytes']} bytes, "
            f"steps {rec['step_s']} s, {rec['collectives']!r} collectives "
            f"and {rec['carried_bytes']!r} bytes a step, K3 at {rec['k3']}"
            + (f", experts a layer {rec['experts']}" if experts else ""))
    log(f"[mesh] {lane} {label}: losses {ranks[0]['losses']} against "
        f"{single['epoch_losses'][:steps]}: max relative difference "
        f"{loss_err!r} (tolerance {LOSS_RTOL!r}); sampled update difference "
        f"in norm {upd_err!r} (tolerance {UPDATE_RTOL!r}) on {n} params; "
        f"launches a rank {ranks[0]['counts']}")
    log(f"[mesh] {lane} each leaf's sampled update gap in norm and its "
        f"share of the update's squared norm: {leaves}")
    moe = (moe_agreement(torch, single, ranks, leaves,
                         MOE_LEAF_RTOL if replay is None else UPDATE_RTOL)
           if cfg.is_moe else {})
    if not loss_err <= LOSS_RTOL:
        raise AssertionError(f"[mesh] {lane}: losses differ by {loss_err}")
    if not upd_err <= UPDATE_RTOL:
        raise AssertionError(f"[mesh] {lane}: updates differ by {upd_err}")
    for failure in moe.get("failures", []):
        raise AssertionError(f"[mesh] {lane}: {failure}")
    return dict(label=label, losses=ranks[0]["losses"], loss_err=loss_err,
                leaf_gaps=leaves,
                **{k: v for k, v in moe.items() if k != "failures"},
                update_err=upd_err, step_s=[r["step_s"] for r in ranks],
                peak_bytes=[r["peak_bytes"] for r in ranks],
                local_n=ranks[0]["local_n"],
                collectives=ranks[0]["collectives"],
                carried_bytes=ranks[0]["carried_bytes"],
                counts=[r["counts"] for r in ranks],
                transport=ranks[0]["transport"])


def routing_flips(torch, single, rec, E):
    """Lane 8d's routing against its (1, 1) run's, call by call (the
    forward and the recomputation): per step, the token rows whose set of
    experts differs and the (token, expert) assignments that differ."""
    a, b = single["routing"], rec["routing"]
    if [x[0] for x in a] != [x[0] for x in b] or single["marks"] != \
            rec["marks"]:
        return None
    steps, start = [], 0
    for end in single["marks"]:
        rows = moved = diff = 0
        for (_, x), (_, y) in zip(a[start:end], b[start:end]):
            d = (torch.zeros(len(x), E).scatter_(1, x.long(), 1.0)
                 - torch.zeros(len(y), E).scatter_(1, y.long(), 1.0)).abs()
            rows += len(x)
            moved += int((d.sum(1) > 0).sum())
            diff += int(d.sum()) // 2
        steps.append(dict(calls=end - start, token_rows=rows,
                          rows_moved=moved, share=moved / max(rows, 1),
                          assignments_moved=diff))
        start = end
    return steps


def leaf_gaps(torch, cfg, sample, gap, want):
    """By leaf path: the sampled update's gap in norm against the
    single-device update, and the leaf's share of that update's squared
    norm (how much of the lane's gap in norm it makes)."""
    import numpy as np

    from repro_torch.train.step import ShardedLayout

    lay = ShardedLayout(cfg, ("data", "model"), (1, 1), (0, 0), fsdp=False)
    leaf = torch.from_numpy(np.searchsorted(
        np.asarray(lay.full.offsets), sample, side="right") - 1)
    return {path: (float(gap[leaf == j].norm() / want[leaf == j].norm()),
                   float(want[leaf == j].norm() ** 2 / want.norm() ** 2))
            for j, path in enumerate(lay.paths) if bool((leaf == j).any())}


def moe_agreement(torch, single, ranks, leaves, rtol):
    """Lane 8d's MoE gates against the (1, 1) run: every rank routes as
    rank 0 (bit for bit); each layer's whole router (put together from
    the ranks' columns) and each expert leaf's sampled update within
    ``rtol`` of the (1, 1) update; the routing flips between the two
    runs printed. Returns the numbers and the gates that failed."""
    cfg, _, _, _ = mesh_lane("8d")
    failures = []
    for r, rec in enumerate(ranks[1:], 1):
        same = len(rec["routing"]) == len(ranks[0]["routing"]) and all(
            la == lb and torch.equal(x, y) for (la, x), (lb, y) in
            zip(rec["routing"], ranks[0]["routing"]))
        if not same:
            failures.append(f"rank {r} routes otherwise than rank 0")
    router_err = []
    for i, (_, want0) in enumerate(single["router0"]):
        full0 = torch.full_like(want0, float("nan"))
        full_end = full0.clone()
        for rec in ranks:
            sl, v0 = rec["router0"][i]
            full0[sl] = v0
            full_end[sl] = rec["router_end"][i][1]
        want = single["router_end"][i][1] - want0
        if not torch.equal(full0, want0):
            failures.append(f"layer {i}'s router: the sharded init differs")
        router_err.append(float(((full_end - full0) - want).norm()
                                / want.norm()))
    expert_err = {path: g for path, (g, _) in leaves.items()
                  if path.endswith(("ffn/wg", "ffn/wu", "ffn/wd"))}
    steps = routing_flips(torch, single, ranks[0], cfg.num_experts)
    log(f"[mesh] 8d routing against the (1, 1) run, a step: "
        f"{steps if steps is not None else 'the calls do not pair up'}")
    log(f"[mesh] 8d router update gap in norm a layer (whole leaves) "
        f"{router_err}, expert leaves' {expert_err} (tolerance {rtol!r})")
    for i, err in enumerate(router_err):
        if not err <= rtol:
            failures.append(f"layer {i}'s router update differs by {err}")
    for path, err in expert_err.items():
        if not err <= rtol:
            failures.append(f"{path}'s update differs by {err}")
    return dict(router_err=router_err, routing=steps, failures=failures)


def mesh_moe_single(torch, kernels):
    """Lane 8d's yardstick: ``make_train_step`` on the (1, 1) mesh,
    MESH_MOE_STEPS fused steps of ``mesh_moe_config``, counts set to 0
    just before (gated as ``expected_launches``); its losses and sampled
    params before and after, as 8a's record gives them to 8b."""
    import gc

    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import model
    from repro_torch.train import step as tstep

    cfg, tcfg = mesh_moe_config()
    n = model.ParamLayout(cfg).n
    sample = torch.randint(0, n, (min(LM_SAMPLES, n),),
                           generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = meshlib.make_test_mesh()
    step, meta = tstep.make_train_step(cfg, tcfg, m, fused=True)
    lay = meta["placement"].layout
    state = tstep.init_train_state(cfg, tcfg, 1, mesh=m)
    idx = sample.to(state.params.device)
    p0 = state.params[0, idx].double().cpu()
    r0 = router_leaves(lay, state.params[0])
    toks = mesh_tokens(cfg, tcfg, 1)
    recs, undo = routing_spy(torch)
    marks = []
    reset_counts(kernels)
    losses, step_s = [], []
    try:
        for s in range(MESH_MOE_STEPS):
            t0 = time.perf_counter()
            state, out = step(state, toks[0, s % 2])
            losses.append(float(out["loss"]))
            step_s.append(time.perf_counter() - t0)
            marks.append(len(recs))
    finally:
        undo()
    counts = read_counts(kernels)
    p_end = state.params[0, idx].double().cpu()
    r_end = router_leaves(lay, state.params[0])
    peak = torch.cuda.max_memory_allocated()
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    expect = {k: v * MESH_MOE_STEPS
              for k, v in expected_launches(cfg, 2, 1).items()}
    label = "qwen3-moe-30b-a3b width L=2 (1, 1) mesh"
    log(f"[mesh] 8d {label}: {n} params; losses {losses}; steps {step_s} s; "
        f"peak memory {peak} bytes; launches {counts} (expected {expect})")
    if counts != expect:
        raise AssertionError(f"[mesh] 8d single: launches {counts}, "
                             f"expected {expect}")
    return dict(label=label, losses=losses, step_s=step_s, peak_bytes=peak,
                counts=counts, epoch_losses=losses, p0=p0, p_end=p_end,
                sample=sample.numpy(), routing=recs, marks=marks,
                router0=r0, router_end=r_end)


def mesh_rank_workers(group):
    """In a rank of lane 8c: CentralVR workers on 'data' (W 2,
    ``dp_replicated``), TP over 'model', MESH_WORKER_STEPS fused steps;
    the worker spread after each step (maxed over the world)."""
    import torch

    from repro_torch.core import spmd
    from repro_torch.launch import mesh as meshlib
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, (cfg, tcfg) = mesh_configs()
    m = meshlib.make_test_mesh()
    step, meta = tstep.make_train_step(cfg, tcfg, m, "data", fused=True)
    pl = meta["placement"]
    state = tstep.init_train_state(cfg, tcfg, 2, mesh=m, vr_workers="data")
    toks = mesh_tokens(cfg, tcfg, 2)
    kernels = kernel_modules()
    torch.cuda.synchronize()
    reset_counts(kernels)
    losses, spreads = [], []
    world = m.group(m.axis_names)
    for s in range(MESH_WORKER_STEPS):
        state, out = step(state, toks[:, s % 2])
        losses.append(float(out["loss"]))
        avg = pl.worker_mean_(state.params.clone())
        spread = (state.params - avg).abs().max().reshape(1)
        spreads.append(float(spmd.pmax_(spread, world)[0]))
    counts = read_counts(kernels)
    return dict(losses=losses, spreads=spreads, counts=counts,
                params=pl.gather_full(state.params), coords=m.coords,
                shape=list(state.params.shape))


def mesh_workers_ref(torch):
    """Lane 8c's yardstick: the port's vmap W 2 epoch runner on the
    lane's tokens and seed, MESH_WORKER_STEPS steps: (losses, params),
    float64 on the host."""
    from repro_torch.train import step as tstep

    _, (cfg, tcfg) = mesh_configs()
    run, _ = tstep.make_epoch_runner(cfg, tcfg, 2, fused=True)
    state = tstep.init_train_state(cfg, tcfg, 2)
    losses = []
    for _ in range(MESH_WORKER_STEPS // 2):
        state, ls = run(state)
        losses.append(ls)
    return torch.cat(losses).double().cpu(), state.params.double().cpu()


def mesh_workers_check(torch, ref, ranks):
    """Lane 8c: MESH_RANKS ranks (``mesh_rank_workers``), W 2 on 'data',
    against ``mesh_workers_ref``: losses and params within LM_TOL, the
    spread above 0 after a local step and exactly 0 at each epoch
    boundary, K1 once a step."""
    want_losses, want = ref
    label = "qwen2-7b reduced f32 (data 2, model 2) workers data"
    for r, rec in enumerate(ranks):
        sp = rec["spreads"]
        if not (all(x > 0.0 for x in sp[0::2])
                and all(x == 0.0 for x in sp[1::2])):
            raise AssertionError(f"[mesh] 8c: rank {r} spreads {sp}: not "
                                 "above 0 between boundaries and 0 at them")
        torch.testing.assert_close(torch.tensor(rec["losses"],
                                                dtype=torch.float64),
                                   want_losses, **LM_TOL)
        torch.testing.assert_close(rec["params"].double(), want, **LM_TOL)
        if rec["counts"]["vr_update"] != MESH_WORKER_STEPS:
            raise AssertionError(f"[mesh] 8c: rank {r} launched K1 "
                                 f"{rec['counts']['vr_update']} times")
    err = float((ranks[0]["params"].double() - want).abs().max())
    log(f"[mesh] 8c {label}: losses {ranks[0]['losses']} (vmap "
        f"{want_losses.tolist()}); spreads {ranks[0]['spreads']}; params "
        f"largest difference {err!r}; launches a rank {ranks[0]['counts']}")
    return dict(label=label, losses=ranks[0]["losses"],
                spreads=ranks[0]["spreads"], param_err=err,
                counts=[r["counts"] for r in ranks])


def phase_mesh(torch, kernels, pinned=False, beside=None):
    """Phase 8: the per-step runtime (8a), FSDP and TP over 4 ranks at the
    Qwen2-7B width (8b), Algorithm 2 across 'data' with TP inside (8c),
    and expert parallelism at the qwen3-moe-30b-a3b width (8d). The
    single-device yardsticks of 8b, 8c and 8d run here first, one after
    the other, then one spawn of MESH_RANKS ranks runs the three lanes
    (``mesh_rank_lanes``); ``beside`` runs here while they do (the full
    script runs phase 9's examples there). ``pinned``: 4 ranks again with
    8d's routing pinned to the single-device run's, which parts what
    routing flips add to 8d's gap from what the arithmetic adds."""
    import gc

    from repro_torch.launch import mesh as meshlib

    t0 = time.perf_counter()
    single = mesh_single(torch, kernels)
    workers_ref = mesh_workers_ref(torch)
    gc.collect()
    torch.cuda.empty_cache()
    moe_single = mesh_moe_single(torch, kernels)
    t_ranks = time.perf_counter()
    ranks = in_thread(meshlib.spawn_workers, MESH_RANKS, mesh_rank_lanes, {
        "8b": single["sample"], "8d": moe_single["sample"]})
    if beside is not None:
        beside()
    ranks = ranks()
    walls = {lane: max(r[lane]["wall_s"] for r in ranks)
             for lane in ("8b", "8c", "8d")}
    log(f"[path] lanes 8b, 8c, 8d: one spawn of {MESH_RANKS} ranks in "
        f"{time.perf_counter() - t_ranks:.1f} s (in the ranks, slowest: "
        f"{ {k: round(v, 1) for k, v in walls.items()} } s)")
    fsdp = mesh_fsdp_check(torch, single, [r["8b"] for r in ranks])
    workers = mesh_workers_check(torch, workers_ref,
                                 [r["8c"] for r in ranks])
    moe = mesh_fsdp_check(torch, moe_single, [r["8d"] for r in ranks],
                          "8d")
    del ranks
    if pinned:
        ranks = meshlib.spawn_workers(MESH_RANKS, mesh_rank_fsdp,
                                      moe_single["sample"], "8d",
                                      moe_single["routing"])
        moe["pinned"] = mesh_fsdp_check(torch, moe_single, ranks, "8d",
                                        moe_single["routing"])
    launches = dict(single["counts"])
    for c in (fsdp["counts"] + workers["counts"] + [moe_single["counts"]]
              + moe["counts"]):
        for k, v in c.items():
            launches[k] += v
    single, moe_single = ({k: v for k, v in rec.items()
                           if k not in ("p0", "p_end", "sample", "routing",
                                        "marks", "router0", "router_end")}
                          for rec in (single, moe_single))
    log(f"[path] phase 8 (mesh) in {time.perf_counter() - t0:.1f} s")
    return dict(single=single, fsdp_tp=fsdp, workers=workers,
                moe_single=moe_single, moe=moe, launches=launches,
                rank_walls_s=walls)


# ---------------------------------------------------------------------------
# Phase 9: the dry run, the roofline and the examples
# ---------------------------------------------------------------------------

# collectives and bytes a step a rank, params a rank, of lanes 8b, 8d and 7b
# as the card counted them (NVIDIA H100 80GB HBM3, 700.00 W; phases 7 and 8)
DRYRUN_LANES = {"8b": (140, 5842792428, 390880256),
                "8d": (164, 8361021420, 468331008),
                "7b": (58, 8192000, 3859304960)}
TOOLING_OUT = ROOT / "build" / "tooling_smoke"
# two epochs of 8 steps (the second applies the VR correction with a
# filled table): 96 steps took 50-73 s on the card's host-bound eager
# path, time the script's 1200 s cannot spare
TRAIN_EXAMPLE_STEPS = 16


def tooling_lanes(torch, mesh_rec=None, serve_rec=None):
    """Lanes 8b, 8d and 7b on the stand-in mesh, every rank, gated against
    ``DRYRUN_LANES`` and, given phase 8's and 7's records, against the
    counts their ranks carried in this run."""
    from repro_torch.config import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib

    measured = {}
    if mesh_rec is not None:
        for lane, key in (("8b", "fsdp_tp"), ("8d", "moe")):
            r = mesh_rec[key]
            measured[lane] = dict(counts=(r["collectives"],
                                          r["carried_bytes"], r["local_n"]),
                                  peak=r["peak_bytes"])
    if serve_rec is not None:
        b16 = serve_rec["tp"]["bf16"]
        measured["7b"] = dict(counts=(b16["collectives_per_step"],
                                      b16["carried_bytes_per_step"],
                                      b16["params"]),
                              peak=[p[0] for p in serve_rec["tp"][
                                  "peak_bytes"]])
    out = {}
    for lane in ("8b", "8d", "7b"):
        t0 = time.perf_counter()
        ranks = []
        if lane == "7b":
            for r in range(SERVE_TP):
                m = meshlib.stand_in_mesh((1, SERVE_TP), ("data", "model"),
                                          rank=r)
                ranks.append(dryrun.dry_decode(
                    get_arch("qwen2-7b"), m, SERVE_GEO["width"],
                    SERVE_GEO["max_seq_len"]))
        else:
            cfg, tcfg, _, _ = mesh_lane(lane)
            for r in range(MESH_RANKS):
                m = meshlib.stand_in_mesh((2, 2), ("data", "model"), rank=r)
                ranks.append(dryrun.dry_train(cfg, tcfg, m))
        counts = [(int(sum(x["cost"].collective_counts.values())),
                   int(x["cost"].collective_bytes), int(x["local_params"]))
                  for x in ranks]
        dry_peak = [x["memory"]["argument_size_in_bytes"]
                    + x["memory"]["temp_size_in_bytes"] for x in ranks]
        seen = measured.get(lane)
        log(f"[tooling] dry run of lane {lane} on the stand-in mesh: "
            f"collectives, bytes a step a rank and params a rank {counts} "
            f"(the card, earlier runs: {DRYRUN_LANES[lane]}; this run: "
            f"{seen['counts'] if seen else 'not run'}); argument + temp "
            f"bytes a rank {dry_peak} beside the card's peak "
            f"{seen['peak'] if seen else 'not measured in this run'} "
            f"(plain attention and autograd on meta, not the fused path; "
            f"not gated); {time.perf_counter() - t0:.1f} s")
        for c in counts:
            if c != DRYRUN_LANES[lane]:
                raise AssertionError(f"[tooling] lane {lane}: the dry run "
                                     f"counts {c}, the card {DRYRUN_LANES[lane]}")
            if seen and c != tuple(seen["counts"]):
                raise AssertionError(f"[tooling] lane {lane}: the dry run "
                                     f"counts {c}, this run's ranks "
                                     f"{seen['counts']}")
        out[lane] = dict(counts=counts[0], dry_peak_bytes=dry_peak,
                         card_peak_bytes=seen["peak"] if seen else None)
    return out


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def tooling_start_combo():
    """``python -m repro_torch.launch.dryrun --arch qwen2-7b --shape
    train_4k --mesh pod`` in a process of its own (CPU only: meta
    tensors, one thread), started right after the build so that it runs
    beside the card's phases (its 42-58 s of tracing would otherwise
    hold phase 9); stopped at exit if it still runs."""
    import os
    env = dict(os.environ, PYTHONPATH=str(_src_dir()),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    TOOLING_OUT.mkdir(parents=True, exist_ok=True)
    with open(TOOLING_OUT / "combo.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen2-7b", "--shape", "train_4k", "--mesh", "pod", "--out",
             str(TOOLING_OUT)], env=env, stdout=out,
            stderr=subprocess.STDOUT)
    atexit.register(_stop, proc)
    return proc


def tooling_finish_combo(proc):
    """The combo's record and its roofline line (``format_table``)."""
    from repro_torch.roofline import analysis
    proc.wait(timeout=900)
    out = (TOOLING_OUT / "combo.log").read_text()
    if proc.returncode:
        raise AssertionError(f"[tooling] the dry run of qwen2-7b train_4k "
                             f"failed:\n{out}")
    rec = json.loads((TOOLING_OUT / "pod" / "qwen2-7b__train_4k.json")
                     .read_text())
    log("[tooling] " + next(line for line in out.splitlines()
                            if line.startswith("OK ")))
    log(f"[tooling] qwen2-7b train_4k pod: record {json.dumps({k: rec[k] for k in rec if k != 'roofline'})}")
    log("[tooling] " + analysis.format_table(
        [analysis.Roofline(**rec["roofline"])]).replace("\n", "\n[tooling] "))
    return rec


def tooling_example(torch, kernels, name, argv):
    """One example's ``main(argv)`` on the card, its kernels counted from
    0: (its result, its wall seconds, the launches)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    res = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    log(f"[tooling] example {name} {' '.join(argv)}: {wall:.1f} s; "
        f"launches {counts}")
    return res, wall, counts


def tooling_examples(torch, kernels):
    """The four examples on the card and their gates."""
    from repro_torch.examples import train_centralvr_100m as train_ex

    # no checkpoint (an empty path): its save writes the 4.9 GB state to
    # disk, time the script cannot spare, and phase 6c already saves and
    # resumes an LM on the card
    ck = ""
    out = {}
    quick, wall, counts = tooling_example(torch, kernels, "quickstart", [])
    out["quickstart"] = dict(wall_s=wall, launches=counts,
                             centralvr_final=quick["centralvr_rels"][-1],
                             sgd_final=quick["sgd_rels"][-1],
                             eval_loss=quick["eval_loss"])
    if not quick["centralvr_rels"][-1] < quick["sgd_rels"][-1]:
        raise AssertionError("[tooling] quickstart: CentralVR's final rel "
                             "is not below SGD's")
    _, wall, counts = tooling_example(torch, kernels, "convex_distributed",
                                      [])
    out["convex_distributed"] = dict(wall_s=wall, launches=counts)
    serve, wall, counts = tooling_example(torch, kernels, "serve_batched",
                                          [])
    out["serve_batched"] = dict(wall_s=wall, launches=counts, paths={
        a: r["path"] for a, r in serve.items()})
    try:
        train_ex.main(["--steps", "8", "--checkpoint", ck])
    except ValueError as e:
        if "head size 40" not in str(e):
            raise
        log(f"[tooling] train_centralvr_100m's default profile refused on "
            f"the card: {e}")
    else:
        raise AssertionError("[tooling] train_centralvr_100m ran head_dim "
                             "40 on the card, which K3 does not take")
    train, wall, counts = tooling_example(
        torch, kernels, "train_centralvr_100m",
        ["--full", "--steps", str(TRAIN_EXAMPLE_STEPS), "--checkpoint", ck])
    out["train_centralvr_100m"] = dict(
        wall_s=wall, launches=counts, first_loss=train["losses"][0],
        last_loss=train["losses"][-1], eval_loss=train["eval_loss"],
        params=train["params"])
    if not train["losses"][-1] < train["losses"][0]:
        raise AssertionError("[tooling] train_centralvr_100m: the loss did "
                             "not fall")
    need = {"quickstart": ("vr_epoch", "vr_update", "rmsnorm",
                           "flash_attention"),
            "convex_distributed": ("vr_epoch",),
            "train_centralvr_100m": ("rmsnorm", "flash_attention")}
    for name, kernels_needed in need.items():
        for k in kernels_needed:
            if not out[name]["launches"][k] > 0:
                raise AssertionError(f"[tooling] example {name} launched "
                                     f"{k} no time")
    return out


def phase_tooling(torch, kernels, proc, mesh_rec=None, serve_rec=None,
                  examples=None):
    """Phase 9: the dry-run lanes, the four examples (``examples``: their
    record, when they already ran beside phase 8's ranks), and the
    production combo that ``proc`` (``tooling_start_combo``) traces."""
    t0 = time.perf_counter()
    lanes = tooling_lanes(torch, mesh_rec, serve_rec)
    if examples is None:
        examples = tooling_examples(torch, kernels)
    combo = tooling_finish_combo(proc)
    launches = dict.fromkeys(kernels, 0)
    for rec in examples.values():
        for k, n in rec["launches"].items():
            launches[k] += n
    seconds = time.perf_counter() - t0
    log(f"[path] phase 9 (tooling) in {seconds:.1f} s")
    return dict(lanes=lanes, examples=examples, seconds=seconds,
                combo={k: combo[k] for k in ("trace_s", "memory",
                                             "roofline", "extrapolated")
                       if k in combo},
                launches=launches)


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
               dtype="bfloat16", window=None):
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, H, hd, device="cuda").to(dt)
    k = torch.randn(B, S, KV, hd, device="cuda").to(dt)
    v = torch.randn(B, S, KV, hd, device="cuda").to(dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        sdpa_kw = dict(is_causal=True)
    else:                           # key j visible iff i - window < j <= i
        pos = torch.arange(S, device="cuda")
        gap = pos[:, None] - pos[None, :]
        sdpa_kw = dict(attn_mask=(gap >= 0) & (gap < window))
    kernel = lambda: fa_kernel.flash_attention(  # noqa: E731
        q, k, v, window=window)
    rec = {"ms": graph_ms(torch, kernel, calls=50, replays=10),
           "plain_ms": graph_ms(torch, lambda: fa_ref.flash_attention_ref(
               q, k, v, window=window), calls=2, replays=3),
           "library_ms": graph_ms(
               torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, enable_gqa=True, **sdpa_kw),
               calls=50, replays=10),
           "eager_ms": eager_ms(torch, kernel, calls=200)}
    # the visible (query, key) pairs: S(S+1)/2 causal, w(w+1)/2 + (S - w)w
    # with a window w
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    # the score and value products over the visible pairs; bf16 on the
    # tensor cores, float32 outside them
    flops = 2 * 2 * pairs * hd * H * B
    bytes_s = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
               / PEAK_BYTES_S)
    ops_s = flops / PEAK_FLOPS["bf16_tensor" if dtype == "bfloat16"
                               else "float32"]
    rec.update(shape=[B, S, H, KV, hd], dtype=dtype, window=window,
               flops=flops,
               bound_ms=max(bytes_s, ops_s) * 1e3,
               bound_by="bytes" if bytes_s >= ops_s else "operations")
    rec.update(tflops=flops / rec["ms"] / 1e9,
               library_tflops=flops / rec["library_ms"] / 1e9,
               bound_share=rec["bound_ms"] / rec["ms"])
    log(f"[time] flash_attention {rec['shape']} {dtype} window {window}: "
        f"kernel {rec['ms']!r} "
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
    if "--fleet" in sys.argv[1:]:
        fleet = phase_fleet(torch, kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"fleet": fleet}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--obs" in sys.argv[1:]:
        telemetry = phase_obs(torch, kernels)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"obs": telemetry}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--archs" in sys.argv[1:]:
        fa_repaired_err = phase_compare_flash_repaired(torch, fa_kernel,
                                                       fa_ref)
        (moe_cfg, _, _), _ = archs_configs()
        moe_shape = vr_update_lm(torch, vr_kernel, vr_ref,
                                 (1, model.ParamLayout(moe_cfg).n),
                                 timed=True)
        archs = phase_archs(torch, kernels)
        if "--profile" in sys.argv[1:]:
            for cfg, tcfg, label in archs_configs():
                phase_profile_lm(torch, label, cfg, tcfg, 1)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"archs": {
            "flash_attention_max_abs_err": fa_repaired_err,
            "vr_update": moe_shape,
            "paths": [{k: r[k] for k in LM_PATH_KEYS} for r in archs]}}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--mesh" in sys.argv[1:]:
        # K2 and K3 against their plain versions at phase 8's shapes first
        phase_compare_rmsnorm(torch, rms_kernel, rms_ref)
        phase_compare_flash(torch, fa_kernel, fa_ref)
        mesh_rec = phase_mesh(torch, kernels, pinned=True)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"mesh": mesh_rec}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--tooling" in sys.argv[1:]:
        combo = tooling_start_combo()
        # K2 and K3 against their plain versions at phase 9's shapes first
        phase_compare_rmsnorm(torch, rms_kernel, rms_ref)
        phase_compare_flash(torch, fa_kernel, fa_ref)
        tooling = phase_tooling(torch, kernels, combo)
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"tooling": tooling}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if "--serve" in sys.argv[1:]:
        serve = phase_serve(torch, kernels, "--profile" in sys.argv[1:])
        log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
        log(f"[card] {smi}")
        log(json.dumps({"serve": serve}))
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
    def clock(what):
        log(f"[clock] {what} done at {time.perf_counter() - t_start:.1f} s")

    combo = tooling_start_combo()
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
    (moe_cfg, _, _), _ = archs_configs()
    moe_shape = vr_update_lm(torch, vr_kernel, vr_ref,
                             (1, model.ParamLayout(moe_cfg).n), timed=True)
    clock("phase 3 (each kernel against its plain version)")
    paths = phase_main_path(torch, kernels)
    clock("phase 4 (convex main path)")
    paths += phase_family(torch, kernels)
    clock("phase 5 (convex family)")
    sparse = phase_sparse(torch, kernels)
    clock("phase 5b (sparse)")
    spmd = phase_spmd(torch, kernels)
    clock("phase 4c (spmd)")
    lm = phase_lm(torch, kernels)
    clock("phase 6 (LM)")
    lm += phase_archs(torch, kernels)
    clock("phase 6d (archs)")
    fleet_jobs = []
    telemetry = phase_obs(torch, kernels,
                          beside=lambda: fleet_jobs.extend(fleet_start()))
    clock("phase 6b (obs)")
    fleet = phase_fleet(torch, kernels, fleet_jobs)
    clock("phase 6c (fleet)")
    serve = phase_serve(torch, kernels, "--profile" in sys.argv[1:])
    clock("phase 7 (serve)")
    examples = {}
    mesh_rec = phase_mesh(torch, kernels, beside=lambda: examples.update(
        tooling_examples(torch, kernels)))
    clock("phase 8 (mesh) and phase 9's examples beside its ranks")
    tooling = phase_tooling(torch, kernels, combo, mesh_rec, serve,
                            examples)
    clock("phase 9 (tooling)")
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
    fa_local_time = time_flash(torch, fa_kernel, fa_ref, S=4096, H=10, KV=1,
                               hd=256, window=2048)
    ssd_time = time_ssd(torch, ssd_kernel, ssd_ref)
    clock("the kernels' times")
    if "--profile" in sys.argv[1:]:
        phase_profile(torch)
        (qcfg, qtcfg), _ = lm_configs()
        phase_profile_lm(torch, "qwen2-7b width L=2 W=1", qcfg, qtcfg, 1)
        (mcfg, mtcfg), _ = mamba_configs()
        for fused in (True, False):
            phase_profile_lm(torch, "mamba2-130m L=24 W=2", mcfg, mtcfg, 2,
                             fused=fused)
        for cfg, tcfg, label in archs_configs():
            phase_profile_lm(torch, label, cfg, tcfg, 1)
    total = dict.fromkeys(kernels, 0)
    total["vr_epoch"] = (sum(p["launches"] for p in paths)
                         + telemetry["launches"])
    total["lazy_epoch"] = sum(r["launches"] for r in sparse["runs"])
    for run in lm:
        for name, n in run["counts"].items():
            total[name] += n
    for name, n in spmd["launches"].items():
        total[name] += n
    for name, n in fleet["launches"].items():
        total[name] += n
    for name, n in serve["launches"].items():
        total[name] += n
    for name, n in mesh_rec["launches"].items():
        total[name] += n
    for name, n in tooling["launches"].items():
        total[name] += n
    mamba = next(r for r in lm if r["label"].startswith("mamba2-130m L=24"))
    lm_paths = [{k: r[k] for k in LM_PATH_KEYS} for r in lm]
    head = epoch_times[0]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(f"[card] {smi}")
    log(json.dumps({"serve": serve}))
    log(json.dumps({"mesh": mesh_rec}))
    log(json.dumps({"tooling": tooling}))
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
        "other_shapes": [lm_red_shape, mamba_shape, moe_shape],
        "bf16_lane_max_abs_err": vr_bf16_err, "paths": lm_paths,
        "fleet_lm": {k: v for k, v in fleet["lm"].items()
                     if k not in ("losses", "resumed_losses")}}, {
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
        "spmd_paths": spmd["runs"], "telemetry": telemetry,
        "fleet": {k: fleet[k] for k in ("lanes", "elastic",
                                         "checkpoints")}}, {
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
                              max_abs_err=rms_err[(8192, 768)])],
        "serve_kernel_ctx": {k: serve["qwen2_7b"][k] for k in (
            "k2_launches", "kernel_ctx_max_rel_err")}}, {
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
                                        (fa_hd256_time, "bfloat16_hd256"),
                                        (fa_local_time,
                                         "bfloat16_hd256_local"))]}, {
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
