"""The port's serving runtime (``repro_torch/serve``): the invariants that
``tests/test_serve.py`` holds the reference to, on the port, and the
port's ids against the reference's.

  * paged decode is bit-identical to the dense-cache oracle, also after
    blocks retire and are reused;
  * continuous batching never changes a request's ids: batched ==
    served alone == any chunk buckets;
  * the engine serves the legacy loop's ids;
  * windowed (ring) layers equal full attention when the window covers
    the context, and a full-recompute greedy oracle after the ring wraps;
  * admission is conservative: a tight pool defers, an impossible
    request fails loudly; unsupported archs are refused;
  * the telemetry validates under both packages' schemas;
  * traces, prompts, and the engine's and legacy loop's ids equal the
    reference's (float32), wherever the reference's top-1 to top-2
    margin is too wide for rounding to flip; at a near-tie the two may
    part, and only on one of the tied ids.

Every case but the comparison with the reference runs at the config's
own bfloat16 compute, on the reference's params, as ``tests/test_serve.py``
runs; the comparison with the reference runs at float32.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.config import get_arch as jget_arch
from repro.models import model as jmodel
from repro.obs import schema as jschema
from repro_torch import convert, obs
from repro_torch.config import get_arch
from repro_torch.models import model
from repro_torch.obs import schema
from repro_torch.serve import (BlockAllocator, Request, ServeEngine,
                               check_arch, prompt_tokens, run_host_loop,
                               serve_trace, synthetic_trace)
from torch_lm_common import LM_TOL

torch.set_num_threads(1)


def _setup(arch="qwen2-7b", seed=0, **replace):
    """(reference cfg, port cfg, reference params, port params) of
    ``arch``.reduced() with ``replace``, from the reference's init."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **replace)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, convert.lm_params_from_jax(jp, cfg)


@pytest.fixture(scope="module")
def setup():
    _, cfg, _, params = _setup()
    return cfg, params


@pytest.fixture(scope="module")
def setup_f32():
    return _setup(dtype="float32")


def _ids(rep):
    return {r.rid: tuple(r.tokens) for r in rep.results}


TRACE = dict(pattern="uniform", prompt_len=12, max_new=6, gap=2,
             vary_new=True, seed=3)
ENGINE = dict(width=3, block_size=4, max_seq_len=32, chunk_buckets=(4, 8),
              device="cpu")


def test_paged_matches_dense_bitwise_with_block_reuse(setup):
    cfg, params = setup
    trace = synthetic_trace(6, **TRACE)
    paged = serve_trace(cfg, trace, params=params, kv_cache="paged",
                        **ENGINE)
    dense = serve_trace(cfg, trace, params=params, kv_cache="dense",
                        **ENGINE)
    assert paged.blocks_reused > 0, "trace never exercised block reuse"
    assert _ids(paged) == _ids(dense)


def test_batched_equals_sequential(setup):
    cfg, params = setup
    trace = synthetic_trace(6, **TRACE)
    batched = _ids(serve_trace(cfg, trace, params=params, **ENGINE))
    for r in trace:
        alone = serve_trace(cfg, [dataclasses.replace(r, arrival=0)],
                            params=params, **ENGINE)
        assert _ids(alone)[r.rid] == batched[r.rid], f"rid {r.rid}"


def test_chunk_bucket_invariance(setup):
    """Prefill chunking is a launch-shape choice, not a numeric one."""
    cfg, params = setup
    trace = synthetic_trace(3, pattern="burst", prompt_len=11, max_new=4)
    base = None
    for buckets in ((16,), (4, 8), (2,)):
        rep = serve_trace(cfg, trace, params=params,
                          **{**ENGINE, "chunk_buckets": buckets})
        if base is None:
            base = _ids(rep)
        else:
            assert _ids(rep) == base, f"buckets {buckets}"


def test_engine_matches_legacy_host_loop(setup):
    """Old path and new path serve the same ids."""
    cfg, params = setup
    trace = synthetic_trace(4, pattern="burst", prompt_len=12, max_new=5)
    eng = serve_trace(cfg, trace, params=params, **ENGINE)
    legacy = run_host_loop(cfg, trace, params=params, width=2, device="cpu")
    assert _ids(eng) == _ids(legacy)


def test_ring_window_covers_full_context_bitwise():
    """A window >= the total length makes the ring a plain cache: bit-equal
    ids to the same arch with windowing off."""
    base = get_arch("starcoder2-15b").reduced()
    win = dataclasses.replace(base, sliding_window=32)
    full = dataclasses.replace(base, sliding_window=None)
    params = model.init_params(full, torch.Generator().manual_seed(1),
                               device="cpu")
    trace = synthetic_trace(2, pattern="burst", prompt_len=10, max_new=5)
    kw = dict(width=2, block_size=4, max_seq_len=20, chunk_buckets=(4,),
              device="cpu")
    a = serve_trace(win, trace, params=params, **kw)
    b = serve_trace(full, trace, params=params, **kw)
    assert _ids(a) == _ids(b)


def test_ring_wraparound_matches_recompute_oracle():
    """After the ring wraps (len > window), decode equals a greedy oracle
    that recomputes the full forward each step."""
    cfg = dataclasses.replace(get_arch("starcoder2-15b").reduced(),
                              sliding_window=12)
    params = model.init_params(cfg, torch.Generator().manual_seed(2),
                               device="cpu")
    prompt_len, max_new = 20, 8          # wraps: 20+8 > window 12
    trace = synthetic_trace(1, pattern="burst", prompt_len=prompt_len,
                            max_new=max_new, seed=5)
    rep = serve_trace(cfg, trace, params=params, width=1, block_size=4,
                      max_seq_len=32, chunk_buckets=(8,), device="cpu")
    got = list(_ids(rep)[0])

    toks = [int(t) for t in prompt_tokens(trace[0], cfg.vocab_size)]
    oracle = []
    with torch.no_grad():
        for _ in range(max_new):
            logits, _ = model.forward(params, cfg,
                                      {"tokens": torch.tensor([toks])})
            nxt = int(np.argmax(logits[0, -1].numpy()))
            oracle.append(nxt)
            toks.append(nxt)
    assert got == oracle


def test_tight_pool_defers_admission(setup):
    cfg, params = setup
    trace = synthetic_trace(4, pattern="burst", prompt_len=12, max_new=6)
    roomy = serve_trace(cfg, trace, params=params, **ENGINE)
    # blocks_for(18) = 5 -> 7 free blocks fit one sequence + change
    tight = serve_trace(cfg, trace, params=params,
                        **{**ENGINE, "num_blocks": 8})
    assert _ids(tight) == _ids(roomy)
    admits = sorted(r.admit_step for r in tight.results)
    assert admits[0] < admits[-1], "tight pool never deferred admission"


def test_impossible_request_raises(setup):
    cfg, params = setup
    eng = ServeEngine(cfg, params, **{**ENGINE, "num_blocks": 3})
    with pytest.raises(RuntimeError, match="can ever free up"):
        eng.run([Request(rid=0, arrival=0, prompt_len=12, max_new=6)])
    too_long = [Request(rid=0, arrival=0, prompt_len=30, max_new=8)]
    with pytest.raises(ValueError, match="exceeds max servable"):
        ServeEngine(cfg, params, **ENGINE).run(too_long)


def test_engine_rejects_unsupported_archs(setup):
    cfg, params = setup
    ssm = get_arch("mamba2-130m").reduced()
    with pytest.raises(ValueError, match="attention-family"):
        check_arch(ssm)
    with pytest.raises(ValueError):
        ServeEngine(ssm, device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        check_arch(get_arch("internvl2-26b").reduced())
    # legacy fallback also refuses ragged prompts (lockstep batching)
    ragged = [Request(rid=0, arrival=0, prompt_len=8, max_new=2),
              Request(rid=1, arrival=0, prompt_len=9, max_new=2)]
    with pytest.raises(ValueError, match="prompt_len"):
        run_host_loop(cfg, ragged, params=params, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_no_fallback(setup):
    """Without a card the engine and the legacy loop raise unless asked
    for the CPU; tensor-parallel decode raises naming its item."""
    cfg, params = setup
    trace = synthetic_trace(1, prompt_len=4, max_new=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_host_loop(cfg, trace, params=params)
    with pytest.raises(NotImplementedError, match=r"item 14 \(TP\)"):
        ServeEngine(cfg, params, mesh=object(), device="cpu")


def test_serve_run_emits_valid_telemetry(setup, tmp_path):
    """A served trace and a legacy run under ``obs.recording`` produce
    records that both packages' validators accept, with the serve spans,
    the admit / retire / report events and the live-lanes metric."""
    cfg, params = setup
    trace = synthetic_trace(2, pattern="burst", prompt_len=8, max_new=3)
    path = str(tmp_path / "serve.jsonl")
    with obs.recording(path):
        serve_trace(cfg, trace, params=params, **ENGINE)
        run_host_loop(cfg, trace, params=params, width=2, device="cpu")
    assert schema.validate_file(path) > 0
    assert jschema.validate_file(path) > 0
    rows = [json.loads(line) for line in open(path)]
    names = {r["name"] for r in rows}
    assert {"serve/run", "serve/prefill", "serve/legacy_run",
            "serve/legacy_prefill", "serve/legacy_decode",
            "serve/decode_live_lanes"} <= names
    events = [r for r in rows if r["kind"] == "event"]
    assert {"serve_admit", "serve_retire", "serve_report"} <= {
        e["name"] for e in events}
    assert [e.get("path") for e in events
            if e["name"] == "serve_report"] == [None, "legacy"]


def test_allocator_lifo_reuse_and_reservations():
    a = BlockAllocator(6)                  # usable ids 1..5
    a.reserve(0, 3)
    assert a.available() == 2
    got = [a.alloc(0) for _ in range(3)]
    assert got == [1, 2, 3]                # deterministic order
    assert a.in_use == 3 and a.reuse_count == 0
    a.release(0, got)
    assert a.available() == 5
    a.reserve(1, 1)
    assert a.alloc(1) == 3                 # LIFO: last freed, first out
    assert a.reuse_count == 1


def test_allocator_guards():
    a = BlockAllocator(4)
    with pytest.raises(RuntimeError, match="exceeds available"):
        a.reserve(0, 4)
    with pytest.raises(RuntimeError, match="without reservation"):
        a.alloc(0)
    a.reserve(0, 2)
    with pytest.raises(RuntimeError, match="exceeds available"):
        a.reserve(1, 2)                    # only 1 unreserved left
    with pytest.raises(ValueError, match="bad block id"):
        a.release(0, [0])                  # trash block is unreleasable


@pytest.mark.parametrize("pattern", ["burst", "uniform", "poisson"])
def test_traces_and_prompts_equal_the_reference(pattern):
    kw = dict(pattern=pattern, prompt_len=7, max_new=9, gap=3,
              vary_new=True, prompt_lens=(5, 11, 2), seed=12)
    want = jserve.synthetic_trace(13, **kw)
    got = synthetic_trace(13, **kw)
    assert [dataclasses.asdict(r) for r in got] == [
        dataclasses.asdict(r) for r in want]
    for r in got:
        np.testing.assert_array_equal(prompt_tokens(r, 512),
                                      jserve.prompt_tokens(r, 512))


def _margins(jcfg, jp, trace, ids):
    """Per request, at every generated position of the reference's ids:
    (top-1 to top-2 margin of the reference's teacher-forced float32
    logits, the margin that rounding cannot flip: 100 times LM_TOL at the
    top logit, the top two ids)."""
    fwd = jax.jit(lambda p, t: jmodel.forward(p, jcfg, {"tokens": t})[0])
    out = {}
    for r in trace:
        toks = list(prompt_tokens(r, jcfg.vocab_size)) + list(ids[r.rid])
        logits = np.asarray(fwd(jp, jnp.asarray([toks], jnp.int32)))[0]
        rows = []
        for i in range(r.max_new):
            row = logits[r.prompt_len - 1 + i]
            top = np.argsort(row)[-2:]
            assert top[1] == ids[r.rid][i], (r.rid, i)
            tol = LM_TOL["atol"] + LM_TOL["rtol"] * abs(row[top[1]])
            rows.append((row[top[1]] - row[top[0]], 100 * tol,
                         set(top.tolist())))
        out[r.rid] = rows
    return out


def _assert_same_ids(got, want, margins):
    """``got`` equals ``want`` at every position whose reference margin
    rounding cannot flip. At a near-tie the streams may part, on one of
    the two tied ids, and are not compared after it. Most positions must
    be compared with a safe margin."""
    safe = total = 0
    for rid, rows in margins.items():
        for i, (margin, bound, top2) in enumerate(rows):
            total += 1
            if got[rid][i] != want[rid][i]:
                assert margin <= bound and got[rid][i] in top2, (
                    f"rid {rid} position {i}: {got[rid][i]} against "
                    f"{want[rid][i]} at margin {margin} (bound {bound})")
                break
            safe += margin > bound
    assert safe >= total // 2, (safe, total)


def test_engine_and_legacy_ids_equal_the_reference(setup_f32):
    """At float32, on the reference's params and trace: the port's engine
    ids equal the reference engine's, its legacy ids the reference legacy
    loop's, wherever the reference's top-1 to top-2 margin is more than
    100 times the logits' tolerance (a near-tie may part them; see
    ``_assert_same_ids``)."""
    jcfg, cfg, jp, params = setup_f32
    trace = synthetic_trace(4, **TRACE)
    want = _ids(jserve.serve_trace(jcfg, trace, params=jp,
                                   **{k: v for k, v in ENGINE.items()
                                      if k != "device"}))
    got = _ids(serve_trace(cfg, trace, params=params, **ENGINE))
    _assert_same_ids(got, want, _margins(jcfg, jp, trace, want))
    burst = synthetic_trace(4, pattern="burst", prompt_len=12, max_new=5)
    want = _ids(jserve.run_host_loop(jcfg, burst, params=jp, width=2))
    got = _ids(run_host_loop(cfg, burst, params=params, width=2,
                             device="cpu"))
    _assert_same_ids(got, want, _margins(jcfg, jp, burst, want))
