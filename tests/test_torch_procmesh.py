"""The port's process-fleet engines (``repro_torch.core.procmesh``) in one
process, against the JAX reference's (``repro.core.procmesh``).

In-process cases on ``LocalKV`` and ``launch.distributed.
set_local_context``: the array codec, the KV semantics of both transports
(``LocalKV`` and the ``TCPStore`` one: no key written twice, a get that
outlives its timeout raises ``KVTimeout``), ``Fault``'s checks,
``worker_blocks``, the one-process engines against the reference's
one-process engines at 1e-10 on the reference's draws and against the
port's own event-serial drivers on the port's draws, the
``topology="process"`` dispatch of ``solve`` and the ``RunSpec``
refusals with the reference's messages. The two-process lanes are in
``test_torch_fleet_lanes.py``.
"""
import datetime
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro
import repro_torch
from repro.config import ConvexConfig as JConvexConfig
from repro.core import convex as jconvex
from repro.core import distributed as jdistributed
from repro.core import procmesh as jprocmesh
from repro.launch import distributed as jlaunchd
from repro_torch import convert
from repro_torch.config import ConvexConfig
from repro_torch.core import distributed, procmesh
from repro_torch.launch import distributed as launchd

torch.set_num_threads(1)

CONVEX_TOL = 1e-10
SPEEDS = (1.0, 1.0, 2.0, 4.0)
KEY = jax.random.PRNGKey(0)


def _close(have, want, tol=CONVEX_TOL):
    np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def prob4():
    cfg = JConvexConfig(problem="logistic", n=12, d=8, seed=0, workers=4)
    sp = jdistributed.make_distributed(jax.random.PRNGKey(0), cfg)
    return (sp, convert.to_problem(sp, device="cpu"),
            jconvex.auto_eta(sp.merged()))


def _comm():
    return procmesh.ProcComm(procmesh.LocalKV(), 0, 1, prefix="t")


def _jcomm():
    return jprocmesh.ProcComm(jprocmesh.LocalKV(), 0, 1, prefix="t")


@pytest.mark.parametrize("p,nprocs", [(4, 2), (5, 2), (3, 3), (8, 3),
                                      (2, 3), (1, 0)])
def test_worker_blocks_split_like_the_reference(p, nprocs):
    try:
        want = jprocmesh.worker_blocks(p, nprocs)
    except ValueError as e:
        with pytest.raises(ValueError) as have:
            procmesh.worker_blocks(p, nprocs)
        assert str(have.value) == str(e)
        return
    assert procmesh.worker_blocks(p, nprocs) == want


def test_array_codec_roundtrip_and_reads_the_reference_s():
    arrays = {"a": np.arange(6.0).reshape(2, 3),
              "b": np.array([1], dtype=np.int64)}
    for blob in (procmesh.encode_arrays(arrays),
                 jprocmesh.encode_arrays(arrays),
                 procmesh.encode_arrays({k: torch.from_numpy(v)
                                         for k, v in arrays.items()})):
        out = procmesh.decode_arrays(blob)
        assert set(out) == {"a", "b"}
        for k in arrays:
            assert out[k].dtype == arrays[k].dtype
            np.testing.assert_array_equal(out[k], arrays[k])


def _store():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return dist.TCPStore("127.0.0.1", port, 1, True,
                         timeout=datetime.timedelta(seconds=30),
                         wait_for_workers=False)


@pytest.mark.parametrize("transport", ["local", "store"])
def test_kv_semantics(transport):
    kv = (procmesh.LocalKV() if transport == "local"
          else procmesh.StoreKV(_store()))
    kv.set("k", b"v")
    assert kv.get("k", 1.0) == b"v"
    # the membership protocol never overwrites a key; the KV enforces it
    with pytest.raises(ValueError, match="already set"):
        kv.set("k", b"w")
    assert kv.get("k", 1.0) == b"v"
    with pytest.raises(procmesh.KVTimeout):
        kv.get("missing", 0.1)
    comm = procmesh.ProcComm(kv, 0, 1, prefix="p")
    comm.put_flag("f", {"a": 1})
    assert comm.get_flag("f", 1.0) == {"a": 1}
    assert comm.peek_flag("f") == {"a": 1} and comm.peek_flag("g") is None
    comm.put("x", v=torch.arange(3.0))
    np.testing.assert_array_equal(comm.get("x", 1.0)["v"], [0.0, 1.0, 2.0])


def test_fault_validation():
    procmesh.Fault(process=1, round_=2)
    for kw, match in ((dict(mode="explode"), "mode"),
                      (dict(process=0), "process 0"), (dict(round_=0), "round"),
                      (dict(mode="stall", rejoin_after=0), "rejoin")):
        args = dict(dict(process=1, round_=2), **kw)
        with pytest.raises(ValueError, match=match) as have:
            procmesh.Fault(**args)
        with pytest.raises(ValueError) as want:
            jprocmesh.Fault(**args)
        assert str(have.value) == str(want.value)


@pytest.mark.parametrize("speeds", [None, SPEEDS], ids=["rr", "speeds"])
def test_single_process_async_engine(prob4, speeds):
    """A one-process fleet runs the wave algebra over a KV exchange: the
    reference's one-process engine at 1e-10 on its draws, the port's
    ``run_async`` bit for bit on the port's."""
    sp, tsp, eta = prob4
    _, want, jtrans = jprocmesh.run_async_process(
        sp, eta=eta, rounds=5, key=KEY, comm=_jcomm(), speeds=speeds)
    state, have, trans = procmesh.run_async_process(
        tsp, eta=eta, rounds=5, comm=_comm(), speeds=speeds,
        orders=convert.elastic_orders(jax.random, KEY, 4, 12, 5))
    _close(have, want)
    assert trans == jtrans == []
    _, rels_ref = distributed.run_async(tsp, eta=eta, rounds=5, seed=4,
                                        speeds=speeds)
    _, rels, _ = procmesh.run_async_process(tsp, eta=eta, rounds=5,
                                            comm=_comm(), seed=4,
                                            speeds=speeds)
    assert torch.equal(rels, rels_ref)


def test_single_process_elastic_mode_changes_nothing(prob4):
    """With one process the heartbeat protocol finds the fleet whole at
    every boundary: the trajectory is the plain engine's."""
    _, tsp, eta = prob4
    _, rels, _ = procmesh.run_async_process(tsp, eta=eta, rounds=4,
                                            comm=_comm(), speeds=SPEEDS)
    _, rels_el, trans = procmesh.run_async_process(
        tsp, eta=eta, rounds=4, comm=_comm(), speeds=SPEEDS,
        elastic_mode=True, hb_timeout=0.1)
    assert torch.equal(rels, rels_el) and trans == []
    with pytest.raises(ValueError, match="requires elastic_mode"):
        procmesh.run_async_process(tsp, eta=eta, rounds=2, comm=_comm(),
                                   fault=procmesh.Fault(1, 1))
    with pytest.raises(ValueError, match="outside the"):
        procmesh.run_async_process(tsp, eta=eta, rounds=2, comm=_comm(),
                                   elastic_mode=True,
                                   fault=procmesh.Fault(1, 1))


def test_single_process_sync_engine(prob4):
    sp, tsp, eta = prob4
    _, want = jprocmesh.run_sync_process(sp, eta=eta, rounds=5, key=KEY,
                                         comm=_jcomm())
    state, have = procmesh.run_sync_process(
        tsp, eta=eta, rounds=5, comm=_comm(),
        orders=convert.sync_orders(jax.random, KEY, 4, 12, 5))
    _close(have, want)
    st_ref, rels_ref = distributed.run_sync(tsp, eta=eta, rounds=5, seed=2)
    state, rels = procmesh.run_sync_process(tsp, eta=eta, rounds=5,
                                            comm=_comm(), seed=2)
    _close(rels, rels_ref, 1e-12)
    _close(state["x"], st_ref.x, 1e-12)


@pytest.mark.parametrize("algo", ["centralvr_async", "centralvr_sync"])
def test_solve_process_topology_matches_local(algo):
    cfg = ConvexConfig(problem="logistic", n=12, d=8, seed=0)
    kw = dict(algo=algo, p=4, rounds=6, seed=0,
              speeds=SPEEDS if algo == "centralvr_async" else None)
    ref = repro_torch.solve(repro_torch.RunSpec(**kw), cfg, device="cpu")
    launchd.set_local_context(1, 0, prefix="solve-t")
    try:
        res = repro_torch.solve(repro_torch.RunSpec(topology="process", **kw),
                                cfg, device="cpu")
    finally:
        launchd.clear_context()
    _close(res.rels, ref.rels, 0.0 if algo == "centralvr_async" else 1e-12)
    prov = res.provenance()["spec"]
    assert prov["topology"] == "process" and prov["elastic"] is False
    assert res.transitions == [] and res.device == "cpu"


def test_solve_process_requires_context(prob4):
    sp, tsp, eta = prob4
    launchd.clear_context()
    spec = repro_torch.RunSpec(algo="centralvr_async", p=4, rounds=2,
                               topology="process")
    with pytest.raises(RuntimeError, match="process mesh"):
        procmesh.solve_process(spec, tsp, eta)
    with pytest.raises(RuntimeError, match="process mesh"):
        repro_torch.solve(spec, tsp, device="cpu")
    jlaunchd.clear_context()
    with pytest.raises(RuntimeError, match="process mesh"):
        jprocmesh.solve_process(repro.RunSpec(algo="centralvr_async", p=4,
                                              rounds=2, topology="process"),
                                sp, eta, KEY)
    launchd.set_local_context(8, 0)
    try:
        with pytest.raises(ValueError, match="cannot be split"):
            procmesh.solve_process(spec, tsp, eta)
    finally:
        launchd.clear_context()


@pytest.mark.parametrize("kw", [
    dict(algo="centralvr_async", p=4, topology="bogus"),
    dict(algo="dsaga", p=4, topology="process"),
    dict(algo="centralvr_async", p=4, topology="process", backend="spmd"),
    dict(algo="centralvr_async", p=4, topology="process", fused=True),
    dict(algo="centralvr_async", p=4, topology="process", prox="l1:0.1"),
    dict(algo="centralvr_sync", p=4, elastic=True),
    dict(algo="centralvr_async", p=4, elastic=True, prox="l1:0.1"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_runspec_topology_refusals_are_the_reference_s(kw):
    with pytest.raises(ValueError) as want:
        repro.RunSpec(**kw)
    with pytest.raises(ValueError) as have:
        repro_torch.RunSpec(**kw)
    assert str(have.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(algo="centralvr_async", p=4, topology="process"),
    dict(algo="centralvr_sync", p=4, topology="process"),
    dict(algo="centralvr_async", p=4, topology="process", elastic=True),
    dict(algo="centralvr_async", p=4, elastic=True, fused=True,
         speeds=(1.0, 2.0, 3.0, 4.0)),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_runspec_accepts_the_fleet_and_elastic_specs(kw):
    import dataclasses
    assert (dataclasses.asdict(repro_torch.RunSpec(**kw))
            == dataclasses.asdict(repro.RunSpec(**kw)))
