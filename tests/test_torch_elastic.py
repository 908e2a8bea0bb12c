"""The port's elastic asynchronous runtime (``repro_torch.core.elastic``)
against the JAX reference's (``repro.core.elastic``).

The reference's ``tests/test_elastic.py`` cases, held to the reference at
1e-10 in float64 on the reference's draws (``convert.elastic_orders``
replays its ``segment_plan`` and per-event permutations), and the port's
own contract on its own draws: constant membership equals ``run_async``
bit for bit, the run after a drop is a checkpoint restored at the new
shape and continued, repeated runs are identical, transitions emit
schema-valid events, and the fused run (one ``vr_epoch`` call an event,
its plain version here) agrees with the unfused one.
"""
import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.config import ConvexConfig as JConvexConfig
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro.core import elastic as jelastic
from repro_torch import convert
from repro_torch.checkpoint import elastic as ckpt
from repro_torch.config import ConvexConfig
from repro_torch.core import convex, distributed, elastic
from repro_torch.obs import recorder, schema

torch.set_num_threads(1)

# the reference's own convex-trajectory tolerance in float64
CONVEX_TOL = 1e-10
SPEEDS = (1.0, 1.0, 2.0, 4.0)
ROUNDS = 6
KEY = jax.random.PRNGKey(0)


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def prob4():
    """(reference problem, port problem, eta): p = 4, 12 samples a
    worker, d = 8."""
    cfg = JConvexConfig(problem="logistic", n=12, d=8, seed=0, workers=4)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(0), cfg)
    return (sp, convert.to_problem(sp, device="cpu"),
            jconvex.auto_eta(sp.merged()))


def _plan(plan):
    return (jelastic.PlannedMembership(4, plan),
            elastic.PlannedMembership(4, plan))


PLANS = [None, {3: (0, 2, 3)}, {2: (0, 1, 3), 4: (0, 1, 2, 3)}, {2: (0, 1)},
         {1: (1, 3), 3: (0, 1, 2, 3), 5: (2,)}]


@pytest.mark.parametrize("plan", PLANS, ids=str)
@pytest.mark.parametrize("speeds", [None, SPEEDS], ids=["rr", "speeds"])
def test_elastic_run_matches_the_reference_on_its_draws(prob4, plan, speeds):
    sp, tsp, eta = prob4
    jplan, tplan = _plan(plan)
    want = jelastic.run_async_elastic(sp, eta=eta, rounds=ROUNDS, key=KEY,
                                      speeds=speeds, membership=jplan)
    have = elastic.run_async_elastic(
        tsp, eta=eta, rounds=ROUNDS, speeds=speeds, membership=tplan,
        orders=convert.elastic_orders(jax.random, KEY, 4, 12, ROUNDS, plan))
    _close(have.rels, want.rels)
    for name in jdistributed.AsyncState._fields:
        _close(getattr(have.state, name), getattr(want.state, name))
    assert have.transitions == want.transitions
    assert have.live == want.live


def test_constant_membership_matches_run_async(prob4):
    sp, tsp, eta = prob4
    _, rels_ref = distributed.run_async(tsp, eta=eta, rounds=ROUNDS, seed=3,
                                        speeds=SPEEDS)
    res = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS, seed=3,
                                    speeds=SPEEDS)
    assert torch.equal(rels_ref, res.rels)
    assert res.transitions == []
    assert tuple(res.live) == tuple(range(4))


def test_chunked_checkpointing_matches_whole_run(prob4, tmp_path):
    _, tsp, eta = prob4
    res_whole = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                          speeds=SPEEDS)
    res_chunk = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                          speeds=SPEEDS,
                                          checkpoint_dir=str(tmp_path),
                                          checkpoint_every=2)
    assert torch.equal(res_whole.rels, res_chunk.rels)
    latest = ckpt.latest_elastic(str(tmp_path))
    assert latest is not None
    man = ckpt.load_manifest(latest)
    # boundaries are interior: with checkpoint_every=2 the last save
    # happens at round 4, not at the run's end
    assert man["p"] == 4 and man["round"] == 4


def test_dropout_prefix_and_determinism(prob4):
    _, tsp, eta = prob4
    _, rels_ref = distributed.run_async(tsp, eta=eta, rounds=ROUNDS,
                                        speeds=SPEEDS)
    plan = elastic.PlannedMembership(4, {3: (0, 2, 3)})
    res = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                    speeds=SPEEDS, membership=plan)
    # before the drop the trajectory is the uninterrupted one, bit-exact
    assert torch.equal(rels_ref[:3], res.rels[:3])
    assert [t["round"] for t in res.transitions] == [3]
    assert res.transitions[0]["lost"] == [1]
    assert res.transitions[0]["live"] == [0, 2, 3]
    res2 = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                     speeds=SPEEDS, membership=plan)
    assert torch.equal(res.rels, res2.rels)
    assert res.transitions == res2.transitions


@pytest.mark.parametrize("live", [(0, 2, 3), (0, 3)])
def test_ckpt_resume_at_new_shape_matches_elastic_run(prob4, tmp_path, live):
    """Save at p = 4 at the boundary, restore at the survivor count,
    continue on the segment's own draws: equal, bit for bit, to the
    elastic run that drops there."""
    _, tsp, eta = prob4
    g0 = convex.grad_norm0(tsp.merged())
    p_new = len(live)
    res_drop = elastic.run_async_elastic(
        tsp, eta=eta, rounds=ROUNDS, speeds=SPEEDS,
        membership=elastic.PlannedMembership(4, {3: live}))
    elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS, speeds=SPEEDS,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=3)
    st_new, man = ckpt.restore_elastic(str(tmp_path / "elastic_00003"),
                                       p_new, device="cpu")
    assert man["p"] == 4
    assert st_new.tables.shape[0] == p_new
    _, rels_cont = elastic.continue_async(
        elastic.reshard_problem(tsp, p_new), st_new, eta=eta, g0=g0,
        start_round=3, rounds=ROUNDS,
        speeds=elastic.survivor_speeds(SPEEDS, live))
    assert torch.equal(rels_cont, res_drop.rels[3:])


def test_continue_async_matches_the_reference_on_its_draws(prob4):
    """The reference's fresh run at the new shape from its handed-over
    state, on the reference's continuation draws."""
    sp, tsp, eta = prob4
    live = (0, 3)
    k_run = jax.random.split(KEY)[1]
    st = jelastic.resync_state(np.linspace(0, 1, 8), np.linspace(1, 2, 8),
                               np.linspace(-1, 1, 48), 2)
    jsp = jelastic.reshard_problem(sp, 2)
    g0 = jconvex.grad_norm0(sp.merged())
    speeds = jelastic.survivor_speeds(SPEEDS, live)
    _, want = jelastic.continue_async(jsp, st, eta=eta, g0=g0,
                                      start_round=3, rounds=ROUNDS,
                                      k_run=k_run, speeds=speeds)
    _, segments = convert.elastic_orders(jax.random, KEY, 4, 12, ROUNDS,
                                         {3: live})
    _, have = elastic.continue_async(
        elastic.reshard_problem(tsp, 2), convert.to_async_state(
            st, device="cpu"), eta=eta,
        g0=convex.grad_norm0(tsp.merged()), start_round=3, rounds=ROUNDS,
        draws=segments[3], speeds=speeds)
    _close(have, want)


def test_rejoin_plan_runs_and_reports_transitions(prob4):
    _, tsp, eta = prob4
    plan = elastic.PlannedMembership(4, {2: (0, 1, 3), 4: (0, 1, 2, 3)})
    res = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                    speeds=SPEEDS, membership=plan)
    assert [t["round"] for t in res.transitions] == [2, 4]
    assert res.transitions[0]["lost"] == [2]
    assert res.transitions[1]["joined"] == [2]
    assert torch.isfinite(res.rels).all()
    assert res.final_rel < 1.0


def test_transitions_emit_schema_valid_events(prob4, tmp_path):
    _, tsp, eta = prob4
    plan = elastic.PlannedMembership(4, {2: (0, 1, 3), 4: (0, 1, 2, 3)})
    path = str(tmp_path / "elastic.jsonl")
    recorder.enable(path, run_id="test-elastic")
    try:
        res = elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                        speeds=SPEEDS, membership=plan)
    finally:
        recorder.disable()
    rows = schema.load_rows(path)
    assert schema.validate_rows(rows) == len(rows)
    names = [r["name"] for r in rows if r["kind"] == "event"]
    assert names.count("worker_lost") == 1
    assert names.count("worker_joined") == 1
    assert names.count("repartition") == 2
    lost = next(r for r in rows if r["name"] == "worker_lost")
    assert lost["worker"] == 2 and lost["round"] == 2
    repart = [r for r in rows if r["name"] == "repartition"]
    assert [(r["p_old"], r["p_new"]) for r in repart] == [(4, 3), (3, 4)]
    assert repart[0]["survivors"] == [0, 1, 3]
    # one metric row a round, across the shapes, equal to the rels
    metric = [r for r in rows if r["kind"] == "metric"]
    assert [r["step"] for r in metric] == list(range(ROUNDS))
    assert [r["value"] for r in metric] == res.rels.tolist()


def test_membership_and_reshard_validation(prob4):
    sp, tsp, eta = prob4
    for plan, match in (({0: (0, 1)}, "full fleet"), ({2: ()}, "no live"),
                        ({2: (1, 1)}, "duplicate"), ({2: (0, 7)}, "out of")):
        with pytest.raises(ValueError, match=match) as want:
            jelastic.PlannedMembership(4, plan)
        with pytest.raises(ValueError) as have:
            elastic.PlannedMembership(4, plan)
        assert str(have.value) == str(want.value)
    # n = 4 * 11 shards over 4 and 2 but not over 3 survivors: validated
    # before any torch work
    cfg = ConvexConfig(problem="ridge", n=11, d=4, seed=1, workers=4)
    sp44 = distributed.make_distributed(torch.Generator().manual_seed(1), cfg)
    with pytest.raises(ValueError, match="does not divide"):
        elastic.run_async_elastic(
            sp44, eta=eta, rounds=ROUNDS,
            membership=elastic.PlannedMembership(4, {2: (0, 1, 2)}))
    with pytest.raises(ValueError, match="plan is for"):
        elastic.run_async_elastic(tsp, eta=eta, rounds=ROUNDS,
                                  membership=elastic.PlannedMembership(3))
    with pytest.raises(ValueError, match="do not divide"):
        elastic.reshard_problem(tsp, 5)
    with pytest.raises(ValueError, match="do not divide") as have:
        elastic.resync_state(np.zeros(8), np.zeros(8), np.zeros(48), 5)
    with pytest.raises(ValueError) as want:
        jelastic.resync_state(np.zeros(8), np.zeros(8), np.zeros(48), 5)
    assert str(have.value) == str(want.value)
    with pytest.raises(ValueError, match="segment that starts at round 3"):
        elastic.run_async_elastic(
            tsp, eta=eta, rounds=ROUNDS,
            membership=elastic.PlannedMembership(4, {3: (0, 1)}),
            orders=convert.elastic_orders(jax.random, KEY, 4, 12, ROUNDS))


def test_reshard_keeps_the_merged_order(prob4):
    sp, tsp, _ = prob4
    for p_new in (1, 2, 3, 6):
        want = jelastic.reshard_problem(sp, p_new)
        have = elastic.reshard_problem(tsp, p_new)
        np.testing.assert_array_equal(have.A.numpy(), np.asarray(want.A))
        np.testing.assert_array_equal(have.b.numpy(), np.asarray(want.b))
    tables = np.arange(48.0).reshape(4, 12)
    np.testing.assert_array_equal(elastic.merge_tables(tables).numpy(),
                                  jelastic.merge_tables(tables))
    st = elastic.resync_state(torch.ones(8), torch.zeros(8),
                              torch.arange(48.0), 3)
    want = jelastic.resync_state(np.ones(8), np.zeros(8), np.arange(48.0), 3)
    for name in jdistributed.AsyncState._fields:
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("plan", [None, {1: (0, 1), 3: (0, 1, 2, 3)}],
                         ids=str)
def test_fused_matches_unfused_on_the_same_draws(prob4, plan):
    """``fused=True`` runs each event as one ``vr_epoch`` call at (1, d)
    (its plain version on the CPU) and the init epoch as one; the
    reference's elastic run has no fused route."""
    _, tsp, eta = prob4
    runs = [elastic.run_async_elastic(
        tsp, eta=eta, rounds=4, speeds=SPEEDS, fused=fused,
        membership=elastic.PlannedMembership(4, plan)) for fused in
        (False, True)]
    _close(runs[1].rels, runs[0].rels)
    _close(runs[1].state.x_c, runs[0].state.x_c)
    assert runs[0].transitions == runs[1].transitions


def test_solve_runs_the_elastic_engine_under_a_plan(prob4):
    """``solve(RunSpec(elastic=True), membership=)`` against the
    reference's, on its draws; ``RunResult.transitions``; the plan is
    refused without ``elastic=True``, with the reference's message."""
    sp, tsp, eta = prob4
    plan = {2: (0, 1)}
    kw = dict(algo="centralvr_async", p=4, rounds=4, speeds=SPEEDS,
              eta=eta, elastic=True)
    want = repro.solve(repro.RunSpec(**kw), sp, key=KEY,
                       membership=jelastic.PlannedMembership(4, plan))
    have = repro_torch.solve(
        repro_torch.RunSpec(**kw), tsp, device="cpu",
        membership=elastic.PlannedMembership(4, plan),
        orders=convert.elastic_orders(jax.random, KEY, 4, 12, 4, plan))
    _close(have.rels, want.rels)
    _close(have.x, want.x)
    assert have.transitions == want.transitions
    assert have.spec.elastic is True
    plain = repro_torch.solve(repro_torch.RunSpec(
        algo="centralvr_async", p=4, rounds=4), tsp, device="cpu")
    assert plain.transitions is None
    spec = dict(algo="centralvr_async", p=4, rounds=4)
    with pytest.raises(ValueError, match="elastic") as e_want:
        repro.solve(repro.RunSpec(**spec), sp,
                    membership=jelastic.PlannedMembership(4, plan))
    with pytest.raises(ValueError) as e_have:
        repro_torch.solve(repro_torch.RunSpec(**spec), tsp, device="cpu",
                          membership=elastic.PlannedMembership(4, plan))
    assert str(e_have.value) == str(e_want.value)


def test_segment_draws_are_a_function_of_seed_start_and_width():
    """Every process derives a segment's draws from (seed, start, p)
    alone, on a generator of the run's device type: two derivations agree,
    segment 0 is run_async's, and other segments draw other streams."""
    a = elastic.segment_draws(5, 2, 6, 3, 16, "cpu")
    assert torch.equal(a, elastic.segment_draws(5, 2, 6, 3, 16, "cpu"))
    assert a.shape == (12, 16)
    assert not torch.equal(a[:4], elastic.segment_draws(5, 3, 6, 3,
                                                        16, "cpu")[:4])
    assert elastic.segment_seed(5, 2, 3) != elastic.segment_seed(5, 2, 4)
    _, events = distributed.draw_async_orders(
        distributed._generator("cpu", 5), 4, 12, 6)
    assert torch.equal(elastic.segment_draws(5, 0, 6, 4, 12, "cpu"), events)
