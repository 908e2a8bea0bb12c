"""The PyTorch port's spmd backend (``core/spmd.py``, ``launch/mesh.py``,
the LM's ``make_epoch_runner(backend="spmd")``) against the JAX
reference, on gloo ranks on the CPU over a ``FileStore``, in float64.

One group of ranks per p (1, 2 and 4) is spawned once for the module and
runs every case of ``test_torch_spmd_cases.cases()`` in it: the eight
algorithms whose reference has an spmd program, at p in {2, 4}, logistic
and ridge, fused (the kernel's plain version on these CPU tensors) and
not, the asynchronous ones round-robin and with speeds, and Algorithm 1
in a group of one rank. Each is held at 1e-10 against the reference's
spmd programs (one subprocess with 8 forced host devices, as
``tests/test_spmd_backend.py`` runs them) and against its vmap and
event-serial drivers in this process, all on the reference's data and
draws (``repro_torch.convert``). The replicated outputs must be
bit-identical across ranks, each rank's state must hold only its own
rows, and a fused run must call the kernel's plain version once per
rank per epoch call. The group of two also runs the LM case.
"""
import concurrent.futures
import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
import test_torch_spmd_cases as tc
from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.core import spmd as jspmd
from repro.data import synthetic as jsynthetic
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.config import ConvexConfig, TrainConfig, get_arch
from repro_torch.core import distributed, runtime
from repro_torch.launch import mesh
from repro_torch.models import model
from repro_torch.train import step as tstep
from torch_lm_common import LM_TOL, assert_trees_close

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the reference's own convex-trajectory tolerance in float64
# (tests/test_fused_agreement.py)
CONVEX_TOL = 1e-10
CASES = tc.cases()
IDS = [c["name"] for c in CASES]

REFERENCE_SPMD = textwrap.dedent("""
    import sys
    sys.path[:0] = ["src", "tests"]
    from repro.core import spmd
    spmd.force_host_devices(8)          # before the first jax operation
    import jax
    jax.config.update("jax_enable_x64", True)
    import test_torch_spmd_cases
    test_torch_spmd_cases.reference_spmd(sys.argv[1],
                                    [int(p) for p in sys.argv[2:]])
""")
LAUNCH = ["--arch", "qwen2-7b", "--reduced", "--steps", "2",
          "--vr-table-size", "2", "--num-workers", "2", "--seq-len", "16",
          "--global-batch", "4", "--microbatch", "1", "--optimizer", "sgd",
          "--backend", "spmd", "--device", "cpu"]


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


def _job(case):
    """A case as a rank takes it: the port's problem, eta and the
    reference's draws, as numpy."""
    prob, eta = tc.reference_problem(case)
    r, key, p = jax.random, jax.random.PRNGKey(tc.SEED_DRAWS), case["p"]
    ns, algo, spec = prob.A.shape[-2], case["algo"], case["spec"]
    orders = {
        "centralvr": lambda: convert.centralvr_orders(r, key, ns, tc.ROUNDS),
        "centralvr_sync": lambda: convert.sync_orders(r, key, p, ns,
                                                      tc.ROUNDS),
        "centralvr_async": lambda: convert.async_orders(r, key, p, ns,
                                                        tc.ROUNDS),
        "dsvrg": lambda: convert.dsvrg_orders(r, key, p, ns, tc.ROUNDS),
        "dsaga": lambda: convert.dsaga_orders(r, key, p, ns, tc.ROUNDS,
                                              spec["tau"]),
        "dist_sgd": lambda: convert.dist_sgd_orders(r, key, p, ns,
                                                    tc.ROUNDS),
        "easgd": lambda: convert.easgd_orders(r, key, p, ns, tc.ROUNDS,
                                              spec["tau"]),
        "ps_svrg": lambda: convert.ps_svrg_orders(r, key, p, ns, tc.ROUNDS),
    }[algo]()
    return dict(case, A=np.array(prob.A), b=np.array(prob.b),
                lam=float(np.asarray(prob.lam)), eta=eta, orders=orders)


def _lm_reference_start():
    """The reference's W = 2 vmap epoch runner (unfused), its initial
    state, worker 0's initial params and the token block."""
    jcfg = dataclasses.replace(jget_arch("qwen2-7b").reduced(),
                               dtype="float32", param_dtype="float32")
    tcfg = JTrainConfig(**tc.lm_train_kw())
    run, meta = jstep.make_epoch_runner(jcfg, tcfg, 2, backend="vmap")
    state = jax.jit(jstep.init_train_state, static_argnums=(0, 1, 3))(
        jcfg, tcfg, jax.random.PRNGKey(0), 2)
    p0 = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), state.params)
    toks = np.asarray(jsynthetic.epoch_tokens(
        jcfg, tcfg.seed, workers=2, steps=2, accum=meta["accum"],
        microbatch=meta["microbatch"], seq=tcfg.seq_len, table_size=2))
    return run, state, p0, toks


def _lm_reference_epochs(run, state):
    """Two epochs: (per-step losses, final params of each worker)."""
    losses = []
    for _ in range(2):
        state, ls = run(state)
        losses.append(np.asarray(ls, dtype=float))
    final = [jax.tree_util.tree_map(lambda x, w=w: np.asarray(x[w]),
                                    state.params) for w in range(2)]
    return np.concatenate(losses), final


def _start(args, env, **kw):
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the module checks, run at once so that it overlaps:
    two subprocesses of the reference's spmd programs, the launcher with
    ``--backend spmd`` in a subprocess, the port's groups of 1, 2 and 4
    ranks, and a group of 2 whose rank 1 fails; meanwhile, in this
    process, the reference's vmap and event-serial runs of every case and
    the LM reference's epochs (the reference runs four at a time, in
    threads). Returns the port's results by p (a list by
    rank), the reference's by case, the LM reference (initial params,
    tokens, losses, final params), the launcher's output and the failing
    group's exception."""
    tmp = tmp_path_factory.mktemp("ref_spmd")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    parts = (("1", "2"), ("4",))
    refs = [_start(["-c", REFERENCE_SPMD, str(tmp / f"{i}.npz"), *ps], env)
            for i, ps in enumerate(parts)]
    launcher = _start(["-m", "repro_torch.launch.train", *LAUNCH], env)
    jobs = {p: [_job(c) for c in CASES if c["p"] == p] for p in (1, 2, 4)}
    lm_run, lm_state, p0, toks = _lm_reference_start()
    with concurrent.futures.ThreadPoolExecutor(4) as pool, \
            concurrent.futures.ThreadPoolExecutor(4) as ref_pool:
        futs = {p: pool.submit(mesh.spawn_workers, p, tc.run_jobs, jobs[p],
                               dict(p0=p0, toks=toks) if p == 2 else None,
                               device="cpu", timeout=600)
                for p in (1, 2, 4)}
        failing = pool.submit(mesh.spawn_workers, 2, tc.fail_on_rank_one,
                              device="cpu", timeout=600)
        lm_ref = (p0, toks) + _lm_reference_epochs(lm_run, lm_state)
        ref_vmap = dict(zip(IDS, ref_pool.map(
            lambda c: tc.reference_run(c, "vmap"), CASES)))
        port = {p: f.result() for p, f in futs.items()}
        failed = failing.exception()
    ref_spmd = {}
    for i, proc in enumerate(refs):
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log
        with np.load(tmp / f"{i}.npz") as z:
            ref_spmd.update(z)
    launched, _ = launcher.communicate(timeout=900)
    assert launcher.returncode == 0, launched
    return dict(port=port, lm_ref=lm_ref, ref_spmd=ref_spmd,
                ref_vmap=ref_vmap, launched=launched, failed=failed)


def _case(name):
    return next(c for c in CASES if c["name"] == name)


@pytest.mark.parametrize("name", IDS)
def test_spmd_matches_the_reference_spmd_program(runs, name):
    case = _case(name)
    for rank in runs["port"][case["p"]]:
        _close(rank[name]["x"], runs["ref_spmd"][name + "/x"])
        _close(rank[name]["rels"], runs["ref_spmd"][name + "/rels"])


@pytest.mark.parametrize("name", IDS)
def test_spmd_matches_the_reference_vmap_and_event_serial_drivers(runs,
                                                                   name):
    """The reference's vmap drivers; for the asynchronous ones its
    event-serial scan with the same schedule (stale fetch for D-SAGA)."""
    x, rels = runs["ref_vmap"][name]
    have = runs["port"][_case(name)["p"]][0][name]
    _close(have["x"], x)
    _close(have["rels"], rels)
    assert have["rels"].shape == (tc.ROUNDS,)


@pytest.mark.parametrize("p", [2, 4])
def test_replicated_outputs_are_bit_identical_across_ranks(runs, p):
    ranks = runs["port"][p]
    for name in (c["name"] for c in CASES if c["p"] == p):
        assert [r[name]["rank"] for r in ranks] == list(range(p))
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[name]["x"], ranks[0][name]["x"])
            np.testing.assert_array_equal(r[name]["rels"],
                                          ranks[0][name]["rels"])
            # every rank joins every collective, inactive ones included
            assert (r[name]["carried"], r[name]["collectives"]) == (
                ranks[0][name]["carried"], ranks[0][name]["collectives"])
        assert ranks[0][name]["carried"] > 0


@pytest.mark.parametrize("p", [2, 4])
def test_each_rank_holds_only_its_own_rows(runs, p):
    """Tables of ns entries and per-worker state of one row, on the rank's
    device; the replicated state is (d,)."""
    for r in runs["port"][p]:
        for name in (c["name"] for c in CASES if c["p"] == p):
            shapes = r[name]["shapes"]
            assert set(r[name]["devices"].values()) == {"cpu"}
            if "tables" in shapes:
                assert shapes["tables"] == (1, tc.N)
            for f in ("x_old", "gbar_old", "x_fetch", "gbar_fetch"):
                if f in shapes:
                    assert shapes[f] == (1, tc.D), (name, f, shapes)
            for f in ("x", "x_c", "gbar", "gbar_c"):
                if f in shapes:
                    assert shapes[f] == (tc.D,), (name, f, shapes)
            assert (r[name]["world"], r[name]["transport"]) == (p, "gloo")


@pytest.mark.parametrize("p", [1, 2, 4])
def test_fused_runs_call_the_plain_vr_epoch_once_per_rank_per_epoch_call(
        runs, p):
    """One ``vr_epoch`` call a fused epoch call on each rank, on its own
    worker: the init epoch and each round (Algorithms 1, 2), the init
    epoch and each event this rank owns (Algorithm 3), each round (D-SVRG),
    each owned event (D-SAGA); none unfused or for the baselines, and no
    kernel launch on the CPU."""
    for r in runs["port"][p]:
        for case in (c for c in CASES if c["p"] == p):
            spec, algo = case["spec"], case["algo"]
            sched = (runtime.event_schedule(p, tc.ROUNDS, spec.get("speeds"))
                     if algo in ("centralvr_async", "dsaga") else None)
            owned = int((sched == r[case["name"]]["rank"]).sum()) \
                if sched is not None else 0
            want = {"centralvr": 1 + tc.ROUNDS,
                    "centralvr_sync": 1 + tc.ROUNDS,
                    "centralvr_async": 1 + owned, "dsvrg": tc.ROUNDS,
                    "dsaga": owned}.get(algo, 0) if case["fused"] else 0
            assert r[case["name"]]["plain_calls"] == want, case["name"]
            assert r[case["name"]]["launches"] == {
                "vr_update": 0, "vr_epoch": 0, "lazy_epoch": 0}


def test_async_speeds_give_ranks_unequal_event_counts():
    """The speed-weighted schedules the cases run do split rounds into
    several waves, so the inactive-rank path is exercised."""
    for p in (2, 4):
        sched = runtime.event_schedule(p, tc.ROUNDS, tc.speeds(p))
        active, _, _ = runtime.wave_partition(sched, p)
        assert active.shape[1] > 1 and not active.all()


def test_spmd_lm_epoch_runner_matches_the_reference_and_the_vmap_runner(
        runs):
    _, toks, want_losses, want_params = runs["lm_ref"]
    p0 = runs["lm_ref"][0]
    cfg, tcfg = tc.lm_cfgs(get_arch, TrainConfig)
    run, _ = tstep.make_epoch_runner(cfg, tcfg, 2, fused=True, device="cpu",
                                     tokens=convert.tokens_from_jax(toks))
    state = tstep.init_train_state(
        cfg, tcfg, 2, params=convert.lm_params_from_jax(p0, cfg),
        device="cpu")
    vmap_losses = []
    for _ in range(2):
        state, ls = run(state)
        vmap_losses.append(ls)
    vmap_losses = torch.cat(vmap_losses)
    layout = model.ParamLayout(cfg)
    for rank, res in enumerate(runs["port"][2]):
        lm = res["lm"]
        assert lm["group_in_meta"]
        assert all(s[0] == 1 for s in lm["shapes"])
        np.testing.assert_allclose(lm["losses"].numpy(), want_losses,
                                   **LM_TOL)
        for w in range(2):     # the epoch boundary averaged the workers
            assert_trees_close(layout.views(lm["params"][0]),
                               convert.lm_params_from_jax(want_params[w],
                                                          cfg), **LM_TOL)
        torch.testing.assert_close(lm["losses"], vmap_losses, rtol=0,
                                   atol=0)
        torch.testing.assert_close(lm["params"][0], state.params[rank],
                                   rtol=0, atol=0)
        torch.testing.assert_close(lm["gbar"][0],
                                   state.vr_state.gbar[rank], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Refusals and the worker group
# ---------------------------------------------------------------------------

def _fake_group(world, rank=0):
    return mesh.WorkerGroup(rank=rank, world=world, group=None,
                            device=torch.device("cpu"), transport="gloo")


def test_world_not_p_refuses_with_the_reference_wording():
    with pytest.raises(ValueError) as want:
        jspmd._check_mesh(jspmd.worker_mesh(1), 4)
    cfg = ConvexConfig(problem="ridge", n=8, d=3, workers=4)
    with pytest.raises(ValueError) as have:
        repro_torch.solve(repro_torch.RunSpec("centralvr_sync", p=4,
                                              rounds=1, backend="spmd"),
                          cfg, group=_fake_group(1))
    assert str(have.value) == str(want.value)
    with pytest.raises(ValueError, match="W=2"):
        tstep.make_epoch_runner(*tc.lm_cfgs(get_arch, TrainConfig), 2,
                                backend="spmd", group=_fake_group(3))


@pytest.mark.parametrize("kw", [
    dict(algo="dsaga", p=2, backend="spmd", fetch="instant"),
    dict(algo="sgd", backend="spmd"), dict(algo="svrg", backend="spmd"),
    dict(algo="saga", backend="spmd")])
def test_spmd_refusals_match_the_reference(kw):
    with pytest.raises(NotImplementedError) as want:
        repro.RunSpec(**kw)
    with pytest.raises(NotImplementedError) as have:
        repro_torch.RunSpec(**kw)
    assert str(have.value) == str(want.value)


def test_instant_fetch_dsaga_driver_refuses_spmd():
    sp = distributed.make_distributed(
        torch.Generator().manual_seed(0),
        ConvexConfig(problem="logistic", n=8, d=3, workers=2))
    with pytest.raises(NotImplementedError, match="event-serial"):
        distributed.run_dsaga(sp, eta=0.1, rounds=1, fetch="instant",
                              backend="spmd", group=_fake_group(2))


def test_transport_rule_and_nccl_refusal(monkeypatch):
    """NCCL when every rank has a card of its own, else gloo; "nccl" on
    shared cards or CPU ranks refuses."""
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert mesh.pick_transport("auto", cpu, 4) == "gloo"
    assert mesh.pick_transport("gloo", cpu, 4) == "gloo"
    for device in (cpu, card):      # no card per rank: none here at all
        with pytest.raises(ValueError, match="nccl"):
            mesh.pick_transport("nccl", device, 2)
    with pytest.raises(ValueError, match="unknown transport"):
        mesh.pick_transport("mpi", cpu, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert mesh.pick_transport("auto", card, 4) == "nccl"
    assert mesh.pick_transport("nccl", card, 4) == "nccl"
    assert mesh.pick_transport("auto", card, 8) == "gloo"
    with pytest.raises(ValueError, match="8 ranks share 4 card"):
        mesh.pick_transport("nccl", card, 8)


def test_worker_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="spawn_workers.*torchrun"):
        mesh.make_worker_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="spawn_workers"):
        repro_torch.solve(repro_torch.RunSpec("dist_sgd", p=2, rounds=1,
                                              backend="spmd"),
                          ConvexConfig(n=8, d=3, workers=2))
    g = _fake_group(4)
    assert mesh.worker_count(g, "data") == 4
    assert mesh.worker_count(g, "none") == mesh.worker_count(g, "pod") == 1


def test_a_failing_rank_fails_the_caller(runs):
    """Rank 1 raises while rank 0 waits for it in a collective: the
    caller gets rank 1's traceback, and no rank is left running."""
    assert isinstance(runs["failed"], RuntimeError)
    assert re.search("(?s)rank 1 of 2 failed.*rank one gives up",
                     str(runs["failed"]))


def test_launcher_runs_spmd_ranks_on_the_cpu(runs):
    """``python -m repro_torch.launch.train --backend spmd`` spawns its W
    ranks and prints rank 0's result once."""
    assert runs["launched"].count("done: 2 steps") == 1, runs["launched"]
