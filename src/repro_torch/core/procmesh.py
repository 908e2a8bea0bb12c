"""Multi-process execution of the sync and wave-partitioned async
runtimes — the port of ``repro/core/procmesh.py``.

Topology: N processes, each owning a CONTIGUOUS block of the p workers
(:func:`worker_blocks`) and running them on its own device
(``launch.mesh.rank_device``). Every process derives the full
deterministic plan — dataset, init state, event schedule, wave
partition, per-event draws — from the shared ``(spec, seed)``, so the
processes agree on every round's structure without exchanging a byte of
control data. Only the wave algebra's payloads move: per-event deltas
``(dx, dgbar)`` are published to a key-value store and applied at the
wave boundary in the schedule's event order — the same sequential delta
additions the event-serial driver performs (``distributed.async_event``:
``x_c + alpha * dx``, one operation after the other), which is why the
two-process asynchronous trajectory equals ``run_async`` and the elastic
engine (``core/elastic.py``) bit for bit in float64 on the same device
type.

The data plane is a ``torch.distributed.TCPStore`` whose server lives in
process 0 (:class:`StoreKV`), as the reference's coordination service
lives in process 0. No process group is initialised: a collective with a
dead peer hangs gloo and NCCL, where a store read times out. The
protocol never writes a key twice, and the store refuses it
(:class:`ProcComm` over either transport).

Elasticity (``elastic_mode``): at every round boundary (every round
boundary is a wave boundary) the processes heartbeat through the store;
process 0 (the arbiter, beside the store's server) waits ``hb_timeout``
seconds for each live peer, declares missing ones dead, admits rejoin
candidates, and publishes the membership decision and the resync state
(central pair + merged VR table, assembled from the boundary table
snapshots every process publishes BEFORE anything can die). Survivors
re-shard per ``core/elastic.py``'s contract, so the trajectory after a
drop equals the event-serial elastic engine replaying the observed
membership plan. Boundary deaths only: a process that vanishes
mid-round trips the data-plane guard (a hard timeout on the delta
fetch) rather than a silent hang. Process 0's trajectory and transition
log are canonical: the launcher reads results from process 0, which is
never the injected-fault process.
"""
from __future__ import annotations

import dataclasses
import datetime
import io
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import convex, distributed, elastic, runtime
from repro_torch.core.distributed import ShardedProblem
from repro_torch.obs import recorder as obs_recorder

# data-plane deadlock guard: a delta/gather fetch outliving this means a
# peer vanished mid-round (outside the boundary-death contract) or the
# store wedged — fail loudly instead of hanging
DATA_TIMEOUT_S = 120.0
# how long a rejoin candidate's heartbeat peek may block the arbiter
PEEK_TIMEOUT_S = 0.05


class KVTimeout(TimeoutError):
    """A blocking KV get ran out of time."""


# ---------------------------------------------------------------------------
# Array codec + KV transports
# ---------------------------------------------------------------------------

def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def encode_arrays(arrays: Dict[str, object]) -> bytes:
    """Arrays or tensors (any device) -> one ``.npz`` blob."""
    buf = io.BytesIO()
    np.savez(buf, **{k: _host(v) for k, v in arrays.items()})
    return buf.getvalue()


def decode_arrays(blob: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(blob)) as data:
        return {k: data[k] for k in data.files}


class LocalKV:
    """In-process KV store: the single-process stand-in for the fleet's
    store, so the engines (and their tests) run without spawning a
    world."""

    def __init__(self):
        self._d: Dict[str, bytes] = {}

    def set(self, key: str, value: bytes) -> None:
        if key in self._d:
            raise ValueError(f"KV key {key!r} already set (the protocol "
                             "never overwrites)")
        self._d[key] = bytes(value)

    def get(self, key: str, timeout_s: float) -> bytes:
        try:
            return self._d[key]
        except KeyError:
            raise KVTimeout(f"key {key!r} not present (single-process KV "
                            "never blocks)") from None


class StoreKV:
    """A ``torch.distributed.TCPStore``: its server lives in process 0
    and outlives every peer. ``set`` on the store overwrites, so a key
    that exists is refused first; a blocking get waits for its key up to
    the call's own timeout (the store-wide one stays the connection's)."""

    def __init__(self, store):
        self._s = store

    def set(self, key: str, value: bytes) -> None:
        if self._s.check([key]):
            raise ValueError(f"KV key {key!r} already set (the protocol "
                             "never overwrites)")
        self._s.set(key, bytes(value))

    def get(self, key: str, timeout_s: float) -> bytes:
        wait = datetime.timedelta(seconds=max(timeout_s, PEEK_TIMEOUT_S))
        try:
            self._s.wait([key], wait)
        except RuntimeError as e:     # torch's DistStoreError on a timeout
            raise KVTimeout(f"key {key!r}: {e}") from None
        return self._s.get(key)


@dataclasses.dataclass
class ProcComm:
    """One process's handle on the world: rank, size, KV transport, and a
    per-run key prefix so repeated runs never collide."""

    kv: object
    pid: int
    nprocs: int
    prefix: str = "run"

    def _k(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def put(self, key: str, **arrays) -> None:
        self.kv.set(self._k(key), encode_arrays(arrays))

    def get(self, key: str, timeout_s: float = DATA_TIMEOUT_S) -> dict:
        return decode_arrays(self.kv.get(self._k(key), timeout_s))

    def put_flag(self, key: str, payload: dict) -> None:
        self.kv.set(self._k(key), json.dumps(payload).encode())

    def get_flag(self, key: str, timeout_s: float) -> dict:
        return json.loads(self.kv.get(self._k(key), timeout_s).decode())

    def peek_flag(self, key: str) -> Optional[dict]:
        try:
            return self.get_flag(key, PEEK_TIMEOUT_S)
        except KVTimeout:
            return None


@dataclasses.dataclass
class Fault:
    """Deterministic fault injection for the elastic lanes: process
    ``process`` drops at the boundary of round ``round_`` — ``exit`` mode
    terminates it (the engine raises :class:`WorkerDropped`), ``stall``
    mode takes it off the air for ``rejoin_after`` rounds and then
    rejoins through the membership protocol."""

    process: int
    round_: int
    mode: str = "exit"           # "exit" | "stall"
    rejoin_after: int = 2

    def __post_init__(self):
        if self.mode not in ("exit", "stall"):
            raise ValueError(f"Fault.mode: {self.mode!r}")
        if self.process == 0:
            raise ValueError(
                "Fault.process: process 0 co-hosts the coordination "
                "service (and the membership arbiter); killing it kills "
                "the control plane, not a worker")
        if self.round_ < 1:
            raise ValueError("Fault.round_: membership changes take effect "
                             "at wave boundaries AFTER round 0")
        if self.mode == "stall" and self.rejoin_after < 1:
            raise ValueError("Fault.rejoin_after must be >= 1: a stalled "
                             "process must miss at least one boundary "
                             "heartbeat to be declared lost")


class WorkerDropped(Exception):
    """Raised inside the engine when THIS process executes an exit-mode
    fault: the caller finalizes (flush telemetry, write partial results)
    and terminates — the dropout is the test, not a failure."""

    def __init__(self, round_: int, rels):
        super().__init__(f"process dropped at round {round_}")
        self.round_ = round_
        self.rels = rels


# ---------------------------------------------------------------------------
# Ownership
# ---------------------------------------------------------------------------

def worker_blocks(p: int, nprocs: int) -> List[range]:
    """Contiguous compact-slot blocks, one per live process rank (uneven
    splits front-loaded, the usual balanced convention)."""
    if nprocs < 1 or p < nprocs:
        raise ValueError(f"cannot split p={p} workers over {nprocs} "
                         "processes (need p >= nprocs >= 1)")
    return [range(i * p // nprocs, (i + 1) * p // nprocs)
            for i in range(nprocs)]


def _wave_layout(row: np.ndarray, p: int):
    """Greedy wave grouping of one round's event row via
    ``runtime.wave_partition``; yields ``(workers_in_event_order,
    row_offset)`` per wave."""
    active, rank, _ = runtime.wave_partition(np.asarray(row), p)
    out = []
    offset = 0
    for w in range(active.shape[1]):
        workers = np.nonzero(active[0, w])[0]
        if workers.size == 0:
            break
        ordered = workers[np.argsort(rank[0, w, workers])]
        out.append((ordered.tolist(), offset))
        offset += workers.size
    return out


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

def run_sync_process(sp: ShardedProblem, *, eta: float, rounds: int,
                     comm: ProcComm, seed: int = 0, orders=None):
    """CentralVR-Sync (Algorithm 2) over the process fleet.

    Init is computed on every process (a pure function of the shared
    ``(sp, eta, draws)``, so replication is exact and free); each round,
    the owned workers' epochs run as one local call and the central
    average is assembled from the KV-exchanged worker blocks — the same
    draws and per-worker arithmetic as ``distributed.run_sync``.
    ``orders`` as ``run_sync`` takes them; None draws them from ``seed``
    as it does. Returns ``({"x", "tables", "gbar"}, rels)``; ``tables``
    holds current rows for this process's workers only."""
    blocks = worker_blocks(sp.p, comm.nprocs)
    own = slice(blocks[comm.pid].start, blocks[comm.pid].stop)
    device = sp.A.device
    if orders is None:
        orders = distributed.draw_sync_orders(
            distributed._generator(device, seed), sp.p, sp.ns, rounds)
    init, per = distributed._as_orders(
        orders, ((sp.p, sp.ns), (rounds, sp.p, sp.ns)), device, sp.ns)
    merged = sp.merged()
    g0 = convex.grad_norm0(merged)
    st = distributed.sync_init(sp, eta, init)
    x_c, gbar_c, tables = st.x, st.gbar, st.tables.clone()
    k = own.stop - own.start
    rels = []
    for r in range(rounds):
        xs_own, tab_own, acc_own = distributed._local_centralvr_epoch(
            sp.A[own], sp.b[own], sp.lam, sp.kind, x_c.expand(k, sp.d),
            tables[own], gbar_c, eta, per[r, own])
        tables[own] = tab_own
        comm.put(f"s/{r}/{comm.pid}", xs=xs_own, accs=acc_own)
        xs = torch.empty((sp.p, sp.d), dtype=x_c.dtype, device=device)
        accs = torch.empty_like(xs)
        for q, qblock in enumerate(blocks):
            rows = slice(qblock.start, qblock.stop)
            if q == comm.pid:
                xs[rows], accs[rows] = xs_own, acc_own
            else:
                part = comm.get(f"s/{r}/{q}")
                xs[rows] = _tensor(part["xs"], device)
                accs[rows] = _tensor(part["accs"], device)
        x_c, gbar_c = xs.mean(0), accs.mean(0)
        rels.append(convex.rel_grad_norm(merged, x_c, g0))
    return {"x": x_c, "tables": tables, "gbar": gbar_c}, torch.stack(rels)


def run_async_process(sp: ShardedProblem, *, eta: float, rounds: int,
                      comm: ProcComm, seed: int = 0, orders=None,
                      speeds=None, elastic_mode: bool = False,
                      hb_timeout: float = 10.0,
                      fault: Optional[Fault] = None):
    """CentralVR-Async (Algorithm 3) over the process fleet, wave by wave.

    Per round: every process derives the round's wave layout from the
    shared segment plan, runs its owned active workers' epochs, publishes
    their ``(dx, dgbar)`` deltas, and applies the wave's deltas IN EVENT
    ORDER — each worker's fresh fetch is the central state right after
    its own event, the event-serial algebra, so the trajectory is
    bit-exact in float64. With ``elastic_mode`` each round boundary also
    runs the heartbeat/membership protocol of the module docstring.
    ``orders``: ``(init, {start round: per-event permutations})`` as
    ``core.elastic.ElasticDraws`` takes them; None derives them from
    ``seed``, as ``run_async`` and the elastic engine do.

    Returns ``(state, rels, transitions)``; ``rels`` (a CPU tensor)
    carries NaN for rounds this process sat out (stall-mode rejoin) —
    process 0's output is canonical and process 0 never sits out.
    """
    p0 = sp.p
    if fault is not None and not elastic_mode:
        raise ValueError("fault injection requires elastic_mode=True")
    if fault is not None and fault.process >= comm.nprocs:
        raise ValueError(f"Fault.process {fault.process} outside the "
                         f"{comm.nprocs}-process world")
    device = sp.A.device
    draws = elastic.ElasticDraws(p0, sp.ns, rounds, device, seed=seed,
                                 orders=orders)
    merged = sp.merged()
    g0 = convex.grad_norm0(merged)

    live_procs: Tuple[int, ...] = tuple(range(comm.nprocs))
    live_workers: Tuple[int, ...] = tuple(range(p0))
    lost_by_proc: Dict[int, Tuple[int, ...]] = {}
    sp_cur = sp
    blocks = worker_blocks(p0, comm.nprocs)
    block = blocks[comm.pid]

    # init replicated locally — a pure function of the shared inputs
    st = distributed.async_init(sp, eta, draws.init)
    x_c, gbar_c = st.x_c, st.gbar_c
    tables, x_old, gbar_old, x_fetch, gbar_fetch = (
        st.tables, st.x_old, st.gbar_old, st.x_fetch, st.gbar_fetch)

    rec = obs_recorder.active()
    rels = torch.full((rounds,), float("nan"), dtype=torch.float64)
    transitions: List[dict] = []
    seg_start = 0

    def replan(r, p_cur):
        return elastic.segment_plan(
            r, rounds, p_cur, elastic.survivor_speeds(speeds, live_workers),
            draws=draws.segment(r, p_cur))

    def handover(r, mem):
        """Adopt the membership decision ``mem`` of boundary ``r``."""
        nonlocal live_procs, live_workers, sp_cur, blocks, block, seg_start
        resync = comm.get(f"resync/{r}")
        live_procs = tuple(mem["procs"])
        live_workers = tuple(mem["workers"])
        p_cur = len(live_workers)
        sp_cur = elastic.reshard_problem(sp, p_cur)
        blocks = worker_blocks(p_cur, len(live_procs))
        block = blocks[live_procs.index(comm.pid)]
        seg_start = r
        return elastic.resync_state(_tensor(resync["x_c"], device),
                                    _tensor(resync["gbar_c"], device),
                                    _tensor(resync["table"], device), p_cur)

    sched_rows, draw_rows = replan(0, p0)
    r = 0
    skip_boundary = False   # set after a rejoin: round r's protocol ran
    while r < rounds:
        if elastic_mode and not skip_boundary:
            # ---- wave-boundary membership protocol --------------------
            # publish the boundary table snapshot BEFORE anything can
            # die: a boundary death always leaves its tables recoverable
            comm.put(f"tab/{r}/{comm.pid}",
                     tables=tables[block.start:block.stop])
            if (fault is not None and comm.pid == fault.process
                    and r == fault.round_):
                if fault.mode == "exit":
                    raise WorkerDropped(r, rels)
                # stall: vanish (no heartbeat this boundary) and rejoin
                # through the candidate path
                rejoined = _rejoin_loop(comm, r + fault.rejoin_after,
                                        rounds, hb_timeout)
                if rejoined is None:
                    return ({"x_c": x_c, "gbar_c": gbar_c}, rels,
                            transitions)
                r, mem = rejoined
                (x_c, gbar_c, tables, x_old, gbar_old, x_fetch,
                 gbar_fetch) = handover(r, mem)
                sched_rows, draw_rows = replan(r, len(live_workers))
                fault = None
                skip_boundary = True
                continue
            comm.put_flag(f"hb/{r}/{comm.pid}", {"pid": comm.pid})
            decision = _membership_round(
                comm, r, live_procs, live_workers, blocks, tables,
                x_c, gbar_c, lost_by_proc, hb_timeout)
            if tuple(decision["procs"]) != live_procs:
                transitions.append(elastic._emit_transition(
                    rec, r, live_workers, tuple(decision["workers"]),
                    decision["detect_s"]))
                for q in live_procs:
                    if q not in decision["procs"]:
                        lost_by_proc[q] = tuple(
                            live_workers[i]
                            for i in blocks[live_procs.index(q)])
                (x_c, gbar_c, tables, x_old, gbar_old, x_fetch,
                 gbar_fetch) = handover(r, decision)
                sched_rows, draw_rows = replan(r, len(live_workers))
        skip_boundary = False

        # ---- one round of waves --------------------------------------
        p_cur = len(live_workers)
        alpha = 1.0 / p_cur
        i = r - seg_start
        row, row_draws = sched_rows[i], draw_rows[i]
        for ordered, offset in _wave_layout(row, p_cur):
            own: Dict[int, tuple] = {}
            for j, s in enumerate(ordered):
                if s not in block:
                    continue
                x_new, table, gtilde = (t[0] for t in
                                        distributed._local_centralvr_epoch(
                    sp_cur.A[s:s + 1], sp_cur.b[s:s + 1], sp_cur.lam,
                    sp_cur.kind, x_fetch[s:s + 1], tables[s:s + 1],
                    gbar_fetch[s:s + 1], eta, row_draws[offset + j][None]))
                dx, dg = x_new - x_old[s], gtilde - gbar_old[s]
                own[s] = (x_new, table, gtilde, dx, dg)
                comm.put(f"d/{seg_start}/{r}/{offset}/{s}", dx=dx, dg=dg)
            # apply the wave's deltas in event order — the separate
            # operations of distributed.async_event, bit for bit
            for s in ordered:
                if s in own:
                    dx, dg = own[s][3:]
                else:
                    part = comm.get(f"d/{seg_start}/{r}/{offset}/{s}")
                    dx = _tensor(part["dx"], device)
                    dg = _tensor(part["dg"], device)
                x_c = x_c + alpha * dx
                gbar_c = gbar_c + alpha * dg
                if s in own:
                    x_new, table, gtilde = own[s][:3]
                    tables[s], x_old[s], gbar_old[s] = table, x_new, gtilde
                    x_fetch[s], gbar_fetch[s] = x_c, gbar_c
        rels[r] = float(convex.rel_grad_norm(merged, x_c, g0))
        r += 1

    state = {"x_c": x_c, "gbar_c": gbar_c, "tables": tables,
             "live": np.asarray(live_workers)}
    return state, rels, transitions


def _membership_round(comm: ProcComm, r: int, live_procs, live_workers,
                      blocks, tables, x_c, gbar_c, lost_by_proc,
                      hb_timeout: float) -> dict:
    """One boundary's membership decision. The arbiter (lowest live rank
    — process 0 by construction, beside the store's server) waits for
    live peers' heartbeats, peeks for rejoin candidates, publishes the
    resync state when membership changes, then the decision row;
    everyone else blocks on the decision row."""
    if comm.pid != min(live_procs):
        return comm.get_flag(f"mem/{r}", timeout_s=3 * hb_timeout + 30)

    t0 = time.perf_counter()
    dead: List[int] = []
    with obs_recorder.span("elastic/heartbeat", round=int(r)):
        for q in live_procs:
            if q == comm.pid:
                continue
            try:
                comm.get_flag(f"hb/{r}/{q}", timeout_s=hb_timeout)
            except KVTimeout:
                dead.append(q)
    detect_s = time.perf_counter() - t0
    joiners = [q for q in range(comm.nprocs)
               if q not in live_procs and comm.peek_flag(f"hb/{r}/{q}")]
    new_procs = tuple(sorted((set(live_procs) - set(dead)) | set(joiners)))
    new_workers = tuple(live_workers)
    if new_procs != tuple(live_procs):
        gone = [w for q in dead
                for w in (live_workers[i]
                          for i in blocks[list(live_procs).index(q)])]
        back = [w for q in joiners for w in lost_by_proc.get(q, ())]
        new_workers = tuple(
            sorted((set(live_workers) - set(gone)) | set(back)))
        # assemble the merged (n,) table from the boundary snapshots (the
        # table is per-SAMPLE: the current fleet always covers all n)
        parts = []
        for rank, q in enumerate(live_procs):
            if q == comm.pid:
                part = tables[blocks[rank].start:blocks[rank].stop]
            else:
                part = comm.get(f"tab/{r}/{q}")["tables"]
            parts.append(_host(part).reshape(-1))
        comm.put(f"resync/{r}", x_c=x_c, gbar_c=gbar_c,
                 table=np.concatenate(parts))
    decision = {"procs": list(new_procs), "workers": list(new_workers),
                "detect_s": detect_s if dead else 0.0}
    comm.put_flag(f"mem/{r}", decision)
    return decision


def _rejoin_loop(comm: ProcComm, target: int, rounds: int,
                 hb_timeout: float):
    """Stall-mode rejoin: from ``target`` on, heartbeat each boundary and
    wait for a membership decision that includes us. Returns ``(round,
    decision)`` for the boundary we rejoined at, or None if the run ended
    first."""
    for r2 in range(target, rounds):
        comm.put_flag(f"hb/{r2}/{comm.pid}", {"pid": comm.pid})
        try:
            mem = comm.get_flag(f"mem/{r2}", timeout_s=3 * hb_timeout + 60)
        except KVTimeout:
            return None
        if comm.pid in mem["procs"]:
            return r2, mem
    return None


# ---------------------------------------------------------------------------
# solve() entry point (RunSpec topology="process")
# ---------------------------------------------------------------------------

def solve_process(spec, sp: ShardedProblem, eta: float, orders=None):
    """Dispatch a ``topology='process'`` RunSpec onto this process's
    context (``repro_torch.launch.distributed`` must have installed it).
    Returns ``(state, x, rels, transitions)``."""
    from repro_torch.launch import distributed as launchd

    ctx = launchd.context()
    if ctx is None:
        raise RuntimeError(
            "RunSpec.topology='process' needs an initialized process "
            "mesh: launch through `python -m repro_torch.launch.distributed` "
            "or call repro_torch.launch.distributed.init_process() first "
            "(DESIGN.md §Multi-host & elasticity)")
    comm = ctx.comm
    if sp.p < comm.nprocs:
        raise ValueError(
            f"RunSpec.p: p={sp.p} workers cannot be split over the "
            f"{comm.nprocs}-process world")
    if spec.algo == "centralvr_sync":
        state, rels = run_sync_process(sp, eta=eta, rounds=spec.rounds,
                                       comm=comm, seed=spec.seed,
                                       orders=orders)
        return state, state["x"], rels, []
    state, rels, transitions = run_async_process(
        sp, eta=eta, rounds=spec.rounds, comm=comm, seed=spec.seed,
        orders=orders, speeds=spec.speeds, elastic_mode=spec.elastic,
        hb_timeout=ctx.hb_timeout, fault=ctx.fault)
    return state, state["x_c"], rels, transitions
