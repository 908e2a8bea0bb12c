"""Continuous-batching serving engine — the port of
``repro/serve/engine.py``.

The engine runs a fixed-width decode batch and re-schedules BETWEEN
decode steps: finished sequences retire (their blocks return to the
pool), waiting requests admit into freed lanes via chunked prefill, and
the decode program then advances every live lane one token.  Dead lanes
ride along as masked padding — their compute is wasted but their KV
writes are invisible (the trash block / a slot's own value written
back), so each request's token stream is bit-identical to serving it
alone.

Scheduling is clocked by the decode-step counter (see serve/trace.py).
One iteration:

  1. ``clock`` advances to the next arrival if the batch is empty.
  2. Arrived requests join the FIFO ready queue.
  3. Admission (FIFO, no skipping — keeps latency fair and tests simple):
     a request admits iff a lane is free AND the allocator can RESERVE
     its worst-case block count ``ceil((prompt+max_new-1)/block_size)``.
     Reservation-on-admit + lazy allocation means pool memory tracks live
     tokens while a running sequence can never starve mid-decode.
  4. Admitted prompts prefill in bucketed chunks (one program call per
     chunk, C tokens a call); the final chunk's logits yield the
     first generated token.
  5. Lanes whose block for the NEXT write position is unallocated grab
     one (lazy allocation), then one decode step runs for all lanes.
  6. Lanes reaching ``max_new`` retire; their blocks are freed and their
     table rows zeroed (back to the trash marker).

Everything host-side is numpy; device work is the two programs from
serve/runtime.py, which write the cache in place. Greedy decoding only:
the argmax is taken on the device (``torch.argmax`` returns the first
maximal index, as ``np.argmax`` does), so one decode step moves ``width``
ids to the host, its one sync.

The engine runs on the current CUDA device unless given ``device``; it
raises without a card rather than fall back to the CPU.

Tensor-parallel decode (``mesh=``, a ``launch.mesh`` process mesh): each
rank holds its shards of the params under ``sharding/specs.py``'s rules
without FSDP (heads, MLP hidden dim, experts and vocab over 'model';
replicated over 'data'), as the reference's ``_place_tp`` places them,
and the whole cache, replicated. Every rank of the mesh runs the same
engine on the same trace: admission, chunking, retirement and warmup
depend only on ids and the step clock, so the ranks issue the same
collectives in the same order, and each takes the argmax of the same
gathered logits. A 'data' axis above one holds replicas.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import ModelConfig
from repro_torch.kernels import resolve_device
from repro_torch.models import model
from repro_torch.serve import runtime
from repro_torch.serve.cache import BlockAllocator, Geometry
from repro_torch.serve.trace import Request, prompt_tokens

DEFAULT_CHUNK_BUCKETS = (16, 64, 128)


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    max_new: int
    tokens: List[int] = field(default_factory=list)
    arrival_step: int = 0
    admit_step: int = -1
    finish_step: int = -1
    t_seen: float = 0.0
    t_first: float = 0.0
    t_finish: float = 0.0

    @property
    def latency_s(self) -> float:
        return self.t_finish - self.t_seen

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_seen


@dataclass
class ServeReport:
    results: List[RequestResult]
    steps: int = 0
    prefill_tokens: int = 0
    prefill_s: float = 0.0
    decode_tokens: int = 0
    decode_s: float = 0.0
    wall_s: float = 0.0
    blocks_reused: int = 0
    compile_s: Dict[str, float] = field(default_factory=dict)

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / max(self.prefill_s, 1e-12)

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / max(self.decode_s, 1e-12)

    def latency_percentiles(self):
        lats = [r.latency_s for r in self.results]
        return (float(np.percentile(lats, 50)),
                float(np.percentile(lats, 95))) if lats else (0.0, 0.0)

    def summary(self) -> dict:
        p50, p95 = self.latency_percentiles()
        return {"requests": len(self.results), "steps": self.steps,
                "prefill_tokens": self.prefill_tokens,
                "prefill_tok_s": self.prefill_tok_s,
                "decode_tokens": self.decode_tokens,
                "decode_tok_s": self.decode_tok_s,
                "latency_p50_s": p50, "latency_p95_s": p95,
                "wall_s": self.wall_s, "blocks_reused": self.blocks_reused}


@dataclass
class _Lane:
    req: Request
    result: RequestResult
    blocks: List[int]
    generated: int = 1          # first token comes from the prefill logits


class ServeEngine:
    """Continuous-batching engine over a paged (or dense-oracle) cache.

    ``width``: decode lanes; ``max_seq_len`` rounds up to a whole number
    of blocks and bounds prompt+max_new; ``num_blocks``: pool size incl.
    trash (default: enough for every lane at full length — the
    interesting schedules use less); ``mesh``: a ("data", "model")
    process mesh for tensor-parallel decode (params sharded by the specs'
    TP rules, cache and token streams replicated; every rank of the mesh
    builds the engine and runs the same trace); ``device``: where it
    runs, the current CUDA device by default (the mesh's with a mesh).
    ``params`` are cast once (``runtime.cast_params``); pass one engine's
    ``params`` to another to share that copy (on a mesh: a full tree,
    which each rank slices). Without ``params`` they are drawn from ``seed``, on a
    mesh one full leaf at a time, each rank keeping its slices, so that a
    rank holds its shard and one leaf at most; the numbers are those of
    ``model.init_params`` on the same device type.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, width: int = 4,
                 block_size: int = 16, max_seq_len: int = 256,
                 num_blocks: int = 0,
                 chunk_buckets: Sequence[int] = DEFAULT_CHUNK_BUCKETS,
                 kv_cache: str = "paged", mesh=None, seed: int = 0,
                 device=None):
        runtime.check_arch(cfg)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"ServeEngine: device={device!r}, but this "
                                 f"rank of the mesh runs on {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device, "repro_torch.serve.ServeEngine")
        self.cfg = cfg
        blocks_per_seq = -(-max_seq_len // block_size)
        if num_blocks <= 0:
            num_blocks = 1 + width * blocks_per_seq
        self.geo = Geometry(width=width, block_size=block_size,
                            blocks_per_seq=blocks_per_seq,
                            num_blocks=num_blocks, kv_cache=kv_cache)
        self.buckets = tuple(sorted(set(int(b) for b in chunk_buckets)))
        if not self.buckets:
            raise ValueError("chunk_buckets must be non-empty")
        if mesh is not None:
            params = tp_params(cfg, mesh, params, seed)
        elif params is None:
            params = model.init_params(
                cfg, torch.Generator(self.device).manual_seed(seed),
                device=self.device)
        self.params = runtime.cast_params(params, cfg, self.device)
        self.cache = runtime.init_cache(cfg, self.geo, device=self.device)
        self.allocator = BlockAllocator(self.geo.num_blocks)
        self._decode, self._prefill = runtime.build_programs(cfg, self.geo)
        if mesh is not None:
            self._decode, self._prefill = (_in_scope(f, mesh, cfg) for f in
                                           (self._decode, self._prefill))
        # host-side lane state
        w = self.geo.width
        self.lanes: List[Optional[_Lane]] = [None] * w
        self.tokens = np.zeros(w, np.int32)       # next decode input
        self.lens = np.zeros(w, np.int32)         # next write position
        self.alive = np.zeros(w, bool)
        self.tables = np.zeros((w, self.geo.blocks_per_seq), np.int32)
        self.compile_s: Dict[str, float] = {}
        self._last_prefill_s = 0.0

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> Dict[str, float]:
        """Run every program once on the real cache with all-dead lanes /
        zero-valid chunks — no throwaway cache allocation. Returns each
        program's first-call seconds (the reference's ``compile_s`` keys;
        here the first call's time)."""
        zero_row = np.zeros(self.geo.blocks_per_seq, np.int32)
        for c in self.buckets:
            t0 = time.perf_counter()
            logits, self.cache = self._prefill(
                self.params, self.cache, np.zeros(c, np.int32), 0, 0, 0,
                zero_row)
            _sync(logits)
            self.compile_s[f"prefill_c{c}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        logits, self.cache = self._decode(
            self.params, self.cache, self.tokens, self.lens, self.alive,
            self.tables)
        _sync(logits)
        self.compile_s["decode"] = time.perf_counter() - t0
        return dict(self.compile_s)

    # -- scheduling --------------------------------------------------------

    def _pick_bucket(self, remaining: int) -> int:
        for b in self.buckets:
            if b >= remaining:
                return b
        return self.buckets[-1]

    def _admit(self, req: Request, lane: int, clock: int,
               result: RequestResult) -> None:
        geo, alloc = self.geo, self.allocator
        need = geo.blocks_for(req.total_len)
        alloc.reserve(lane, need)
        rec = obs.active()
        if rec:
            rec.event("serve_admit", rid=req.rid, lane=lane, step=clock,
                      prompt_len=req.prompt_len, max_new=req.max_new,
                      blocks_reserved=need)
        toks = prompt_tokens(req, self.cfg.vocab_size)
        row = np.zeros(geo.blocks_per_seq, np.int32)
        n_prompt_blocks = (req.prompt_len - 1) // geo.block_size + 1
        blocks = [alloc.alloc(lane) for _ in range(n_prompt_blocks)]
        row[:n_prompt_blocks] = blocks
        pos = 0
        t0 = time.perf_counter()
        with obs.span("serve/prefill", rid=req.rid, tokens=req.prompt_len):
            while pos < req.prompt_len:
                rem = req.prompt_len - pos
                c = self._pick_bucket(rem)
                n_valid = min(c, rem)
                chunk = np.zeros(c, np.int32)
                chunk[:n_valid] = toks[pos:pos + n_valid]
                logits, self.cache = self._prefill(
                    self.params, self.cache, chunk, pos, n_valid, lane, row)
                pos += n_valid
            first = int(logits.argmax())
        self._last_prefill_s = time.perf_counter() - t0
        self.lanes[lane] = _Lane(req=req, result=result, blocks=blocks)
        self.tokens[lane] = first
        self.lens[lane] = req.prompt_len
        self.alive[lane] = True
        self.tables[lane] = row
        result.admit_step = clock
        result.t_first = time.time()
        result.tokens.append(first)

    def _retire(self, lane: int, clock: int) -> None:
        ln = self.lanes[lane]
        self.allocator.release(lane, ln.blocks)
        rec = obs.active()
        if rec:
            rec.event("serve_retire", rid=ln.req.rid, lane=lane, step=clock,
                      generated=ln.generated)
        ln.result.finish_step = clock
        ln.result.t_finish = time.time()
        self.lanes[lane] = None
        self.alive[lane] = False
        self.lens[lane] = 0
        self.tokens[lane] = 0
        self.tables[lane] = 0

    def _ensure_blocks(self) -> None:
        geo = self.geo
        for lane, ln in enumerate(self.lanes):
            if ln is None:
                continue
            blk_idx = int(self.lens[lane]) // geo.block_size
            if self.tables[lane, blk_idx] == 0:
                blk = self.allocator.alloc(lane)
                ln.blocks.append(blk)
                self.tables[lane, blk_idx] = blk

    # -- main loop ---------------------------------------------------------

    def run(self, reqs: Sequence[Request]) -> ServeReport:
        geo = self.geo
        for r in reqs:
            if r.total_len > geo.context:
                raise ValueError(
                    f"request {r.rid}: prompt+max_new={r.total_len} exceeds "
                    f"max servable length {geo.context}")
        if len({r.rid for r in reqs}) != len(reqs):
            raise ValueError("request ids must be unique")
        waiting = deque(sorted(reqs, key=lambda r: (r.arrival, r.rid)))
        ready: deque = deque()
        results = {r.rid: RequestResult(rid=r.rid, prompt_len=r.prompt_len,
                                        max_new=r.max_new,
                                        arrival_step=r.arrival)
                   for r in reqs}
        rep = ServeReport(results=[])
        clock = 0
        wall0 = time.perf_counter()
        rec = obs.active()
        with obs.span("serve/run", requests=len(reqs), width=geo.width,
                      kv_cache=geo.kv_cache):
            while True:
                while waiting and waiting[0].arrival <= clock:
                    r = waiting.popleft()
                    results[r.rid].t_seen = time.time()
                    ready.append(r)
                # FIFO admission into free lanes
                while ready:
                    free = [i for i, ln in enumerate(self.lanes)
                            if ln is None]
                    r = ready[0]
                    if not free or (self.allocator.available()
                                    < geo.blocks_for(r.total_len)):
                        break
                    ready.popleft()
                    self._admit(r, free[0], clock, results[r.rid])
                    rep.prefill_tokens += r.prompt_len
                    rep.prefill_s += self._last_prefill_s
                    if r.max_new == 1:          # done at prefill already
                        self.lanes[free[0]].generated = 1
                        self._retire(free[0], clock)
                if not self.alive.any():
                    if ready:
                        r = ready[0]
                        raise RuntimeError(
                            f"request {r.rid} needs "
                            f"{geo.blocks_for(r.total_len)} blocks but only "
                            f"{self.allocator.available()} can ever free up")
                    if waiting:
                        clock = waiting[0].arrival
                        continue
                    break
                self._ensure_blocks()
                t0 = time.perf_counter()
                logits, self.cache = self._decode(
                    self.params, self.cache, self.tokens, self.lens,
                    self.alive, self.tables)
                nxt = logits.argmax(-1).cpu().numpy()
                step_s = time.perf_counter() - t0
                rep.decode_s += step_s
                clock += 1
                rep.steps += 1
                n_live = int(self.alive.sum())
                rep.decode_tokens += n_live
                if rec:
                    rec.metric("serve/decode_live_lanes", step=clock,
                               value=float(n_live))
                for lane, ln in enumerate(self.lanes):
                    if ln is None:
                        continue
                    tok = int(nxt[lane])
                    ln.result.tokens.append(tok)
                    ln.generated += 1
                    self.tokens[lane] = tok
                    self.lens[lane] += 1
                    if ln.generated >= ln.req.max_new:
                        self._retire(lane, clock)
        rep.results = [results[r.rid] for r in
                       sorted(reqs, key=lambda q: q.rid)]
        rep.wall_s = time.perf_counter() - wall0
        rep.blocks_reused = self.allocator.reuse_count
        rep.compile_s = dict(self.compile_s)
        if rec:
            rec.event("serve_report", **{k: v for k, v in
                                         rep.summary().items()})
        return rep


def tp_params(cfg: ModelConfig, mesh, params=None, seed: int = 0):
    """This rank's params tree on ``mesh`` under ``sharding/specs.py``
    without FSDP (``tree_specs(fsdp=False, axis_sizes=...)``, the
    reference's ``_place_tp``), on the mesh's device: the slices of the
    full tree ``params`` (``ShardedLayout.shard_tree``), or, without it, each full leaf drawn from ``seed`` in layout
    order (``model.init_params``'s draw) and sliced, one leaf at a time."""
    from repro_torch.train.step import ShardedLayout
    lay = ShardedLayout(cfg, mesh.axis_names, mesh.shape, mesh.coords,
                        fsdp=False)
    if params is not None:
        return lay.shard_tree(params, mesh.device)
    gen = torch.Generator(mesh.device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    leaves = []
    for shp, init, sl, local in zip(lay.full.shapes, lay.inits, lay.slices,
                                    lay.shapes):
        full = model.fill_(torch.empty(shp, dtype=dtype,
                                       device=mesh.device), init, gen)
        leaves.append(full if shp == local else full[sl].clone())
        del full
    return lay.unflatten(leaves)


def _in_scope(program, mesh, cfg):
    """``program`` called in the mesh's tensor-parallel context
    (``sharding/tp.py``)."""
    from repro_torch.sharding import tp

    @functools.wraps(program)
    def call(*args):
        with tp.scope(mesh, cfg):
            return program(*args)
    return call


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def serve_trace(cfg: ModelConfig, reqs: Sequence[Request], *, params=None,
                warmup: bool = True, **kw) -> ServeReport:
    """One-call convenience: build an engine, warm it up, run the trace."""
    eng = ServeEngine(cfg, params, **kw)
    if warmup:
        eng.warmup()
    return eng.run(reqs)
