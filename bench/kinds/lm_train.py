"""The CentralVR LM training cells: the port's epoch runner
(``repro_torch.train.step.make_epoch_runner``) on a dense decoder of the
Qwen2 kind, one worker on one card.

Set-up builds the one training object a run has (the state from the
benchmark's weights, the runner over the benchmark's token block), drives
it through its first two calls (four steps: two communication epochs of
M = 2 steps, through the same runner, feed and shapes as the window) and
reads what the check compares: each step's loss, the first gradient as
the optimizer gets it (table row 0 after the first call: its correction
v = g - 0 + 0 is g itself) and the change of the weights after the four
steps. The window then calls the same runner on the same state, whole
epochs, until its time is up, and ends in a synchronise.

After the window the program's state is freed and the plain reference
(``bench/reference/lm_dense.py``) follows the same four steps from the
same weights and tokens in float32. The numbers compared, each by its
limit in ``bench/limits/<cell>.json``:

  loss_gap    the largest gap of a step's loss, in nats;
  loss_gap_first2  the same over the first two steps;
  grad_gap    the first gradient's worst leaf: |norm(program) -
              norm(reference)| over the larger of the reference leaf's
              norm and the median leaf's;
  change_gap  the same of the weights' change after four steps, over the
              leaves whose reference gradient is at least a thousandth of
              the median leaf's (a key's bias has none under softmax and
              moves by rounding alone);
  change_gap_median  the median leaf's of those gaps.

The cell's limits file names the numbers its check compares.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import time

import torch

from bench.data import lm_tokens, lm_weights
from bench.harness import trace as tracelib
from bench.harness.runs import Outcome, free, peak, reset_peak, sync
from bench.reference import lm_dense

SETUP_CALLS = 2           # the calls (communication epochs) set-up drives
TRACE_SECONDS = 4.0       # the traced stretch of a traced window
EXCLUDE_BELOW = 1e-3      # of the median leaf's reference gradient


def model_config(conf: dict):
    """The port's ``ModelConfig`` of a Qwen2 configuration file."""
    from repro_torch.config import ModelConfig
    if conf["model_type"] != "qwen2" or conf["hidden_act"] != "silu":
        raise ValueError("lm_train drives Qwen2 decoders (SwiGLU, biases on "
                         f"q, k and v); got {conf['model_type']!r}")
    if conf["rms_norm_eps"] != 1e-6 or conf.get("use_sliding_window"):
        raise ValueError("the port's RMSNorm takes eps 1e-6 and its "
                         "training path full causal attention")
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    tr = conf["train"]
    return ModelConfig(
        name=conf["model_type"], family="dense",
        num_layers=conf["num_hidden_layers"], d_model=d, num_heads=H,
        num_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or d // H,
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        qkv_bias=True, rope_theta=float(conf["rope_theta"]),
        norm_type="rmsnorm", mlp_type="swiglu",
        tie_embeddings=conf["tie_word_embeddings"],
        dtype=tr["compute_dtype"], param_dtype=tr["param_dtype"])


def train_config(conf: dict, traffic: dict):
    from repro_torch.config import TrainConfig
    tr = conf["train"]
    return TrainConfig(
        seq_len=traffic["seq"],
        global_batch=traffic["accum"] * traffic["microbatch"],
        microbatch=traffic["microbatch"],
        learning_rate=tr["learning_rate"], optimizer=tr["optimizer"],
        vr=tr["algorithm"], vr_table_size=tr["vr_table_size"],
        local_epoch=tr["local_epoch"], remat=tr["remat"])


def leaf_paths(conf: dict):
    """[(benchmark leaf name, path in the port's params tree)]."""
    out = [("embed", ("embed", "tok"))]
    for i in range(conf["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", ("layers", i, "norm1", "scale"))]
        out += [(p + k, ("layers", i, "mixer", k))
                for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo")]
        out += [(p + "mlp_norm", ("layers", i, "norm2", "scale"))]
        out += [(p + k, ("layers", i, "ffn", k)) for k in ("wg", "wu", "wd")]
    return out + [("final_norm", ("final_norm", "scale")),
                  ("head", ("head", "w"))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def program_tree(named: dict, layout, conf: dict) -> dict:
    """The port's params tree over the benchmark's leaves, each a view
    shaped as the port's layout holds it."""
    paths = {path: name for name, path in leaf_paths(conf)}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        return named[paths[path]].view(layout.shapes[tree])
    return walk(layout.tree)


def named_views(layout, row: torch.Tensor, conf: dict) -> dict:
    """{benchmark leaf name: view of the port's flat row}."""
    tree = layout.views(row)
    return {name: _get(tree, path) for name, path in leaf_paths(conf)}


def _norms(named: dict) -> dict:
    vals = torch.stack([torch.linalg.vector_norm(t.float())
                        for t in named.values()]).tolist()
    return dict(zip(named, vals))


def _change_norms(named: dict, x0: dict) -> dict:
    vals = torch.stack([torch.linalg.vector_norm(
        t.float().reshape(x0[n].shape) - x0[n]) for n, t in named.items()])
    return dict(zip(named, vals.tolist()))


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """{leaf: |prog - ref| / max(ref, median of ref)} over ``names``."""
    med = statistics.median(ref.values())
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
            for n in names}


@dataclasses.dataclass
class Program:
    """The training object of a run and what set-up read from it."""
    state: object
    runner: object
    steps_per_call: int
    losses: list          # the set-up steps' losses
    grad0: dict           # the first gradient's norm by leaf
    change: dict          # the weights' change after set-up, by leaf


def build(conf: dict, traffic: dict, seed: int, device, tokens,
          variant=None) -> Program:
    """Set-up: the state from the seed's weights, the runner, and the
    first ``SETUP_CALLS`` calls. ``variant="control"`` keeps the weights
    and VR state in bfloat16 (the port's own lower-precision path)."""
    from repro_torch.models import model
    from repro_torch.train import step
    mcfg = model_config(conf)
    if variant == "control":
        mcfg = dataclasses.replace(mcfg, param_dtype="bfloat16")
    tcfg = train_config(conf, traffic)
    layout = model.ParamLayout(mcfg)
    flat0 = lm_weights.make(conf, seed, device)
    if flat0.numel() != layout.n:
        raise ValueError(f"the benchmark's leaves hold {flat0.numel()} "
                         f"weights, the port's layout {layout.n}")
    tree = program_tree(lm_weights.views(flat0, conf), layout, conf)
    state = step.init_train_state(mcfg, tcfg, conf["train"]["workers"],
                                  params=tree, device=device)
    del tree, flat0
    runner, meta = step.make_epoch_runner(
        mcfg, tcfg, conf["train"]["workers"], fused=conf["train"]["fused"],
        device=device, tokens=tokens)
    losses, grad0 = [], None
    for c in range(SETUP_CALLS):
        state, l = runner(state)
        losses += l.tolist()
        if c == 0:
            grad0 = _norms(named_views(state.layout,
                                       state.vr_state.table[0][0], conf))
    x0 = lm_weights.views(lm_weights.make(conf, seed, device), conf)
    change = _change_norms(named_views(state.layout, state.params[0], conf),
                           x0)
    del x0
    return Program(state, runner, meta["comm_every"], losses, grad0, change)


def reference(conf: dict, seed: int, device, tokens, steps: int) -> dict:
    """The plain reference's losses, first gradient and change by leaf."""
    flat = lm_weights.make(conf, seed, device)
    out = lm_dense.train(conf, conf["train"], flat,
                         lm_weights.views(flat, conf), tokens, steps)
    x = lm_weights.views(out["x"], conf)
    x0 = lm_weights.views(lm_weights.make(conf, seed, device), conf)
    return {"losses": out["losses"], "grad0": out["grad0"],
            "change": _change_norms(x, x0)}


def compare(prog: Program, ref: dict) -> dict:
    """{number: value} of the check, and the leaves that set the worst
    leaf gaps."""
    names = list(ref["grad0"])
    med = statistics.median(ref["grad0"].values())
    moved = [n for n in names if ref["grad0"][n] >= EXCLUDE_BELOW * med]
    grad = leaf_gaps(prog.grad0, ref["grad0"], names)
    change = leaf_gaps(prog.change, ref["change"], moved)
    gaps = [abs(a - b) for a, b in zip(prog.losses, ref["losses"])]
    return {
        "loss_gap": max(gaps),
        "loss_gap_first2": max(gaps[:2]),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "change_gap_median": statistics.median(change.values()),
        "grad_worst_leaf": max(grad, key=grad.get),
        "change_worst_leaf": max(change, key=change.get),
    }


def readings(cell, seed: int, device, variant=None) -> dict:
    """The check's numbers of one seed, with no window: set-up, the
    program freed, the reference."""
    tokens = _tokens(cell, seed, device)
    prog = build(cell.config, cell.traffic, seed, device, tokens, variant)
    prog.state = prog.runner = None
    free(device)
    ref = reference(cell.config, seed, device, tokens, len(prog.losses))
    return dict(compare(prog, ref), losses=prog.losses,
                losses_reference=ref["losses"])


def _tokens(cell, seed: int, device):
    conf, traffic = cell.config, cell.traffic
    return lm_tokens.epoch_tokens(
        seed, vocab=conf["vocab_size"],
        table_size=conf["train"]["vr_table_size"],
        local_epoch=conf["train"]["local_epoch"], accum=traffic["accum"],
        microbatch=traffic["microbatch"], seq=traffic["seq"], device=device)


def run(cell, *, seed: int, seconds: float, trace: bool, device, clock0,
        variant=None) -> Outcome:
    conf, traffic = cell.config, cell.traffic
    tokens = _tokens(cell, seed, device)
    prog = build(conf, traffic, seed, device, tokens, variant)
    tokens_per_step = traffic["accum"] * traffic["microbatch"] * traffic["seq"]
    sync(device)
    setup_peak = peak(device)
    reset_peak(device)
    setup_s = time.perf_counter() - clock0

    losses, calls = [], 0
    state = prog.state
    prof = tracelib.profiler() if trace else None
    if prof is not None:
        prof.start()            # the profiler's own start is not timed
        sync(device)
    t0 = time.perf_counter()
    if prof is not None:
        while calls == 0 or time.perf_counter() - t0 < min(seconds,
                                                            TRACE_SECONDS):
            state, l = prog.runner(state)
            losses.append(l)
            calls += 1
        sync(device)
        traced_s = time.perf_counter() - t0
        prof.stop()
    traced_calls, t_traced = calls, time.perf_counter()
    while calls == 0 or time.perf_counter() - t0 < seconds:
        state, l = prog.runner(state)
        losses.append(l)
        calls += 1
    sync(device)
    t1 = time.perf_counter()
    wall = t1 - t0
    window_peak = peak(device)
    steps = calls * prog.steps_per_call
    window_losses = torch.cat(losses).tolist()
    failed = sum(not math.isfinite(v) for v in window_losses)

    run_info, tr = None, None
    if prof is not None:
        tr = tracelib.Trace.from_profiler(prof, traced_s)
        # the step rate of the untraced rest of the window (the profiler
        # slows the host), or of the traced stretch where nothing is left
        timed = ((calls - traced_calls, t1 - t_traced)
                 if calls > traced_calls else (traced_calls, tr.window_s))
        run_info = {"kind": "lm_train", "config": conf, "traffic": traffic,
                    "params": prog.state.layout.n,
                    "workers": conf["train"]["workers"],
                    "units_traced": traced_calls * prog.steps_per_call,
                    "units_timed": timed[0] * prog.steps_per_call,
                    "seconds_timed": timed[1]}
    prog.state = prog.runner = state = None
    losses = None
    free(device)
    t_ref = time.perf_counter()
    ref = reference(conf, seed, device, tokens, len(prog.losses))
    reference_s = time.perf_counter() - t_ref
    values = compare(prog, ref)
    checks = {k: (values[k], lim) for k, lim in cell.limits.items()}
    correct = all(v <= lim for v, lim in checks.values()) and failed == 0
    e2e = {"train_tokens_per_s": steps * tokens_per_step / wall,
           "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s,
           "reference_s": reference_s, "last_loss": window_losses[-1]}
    return Outcome(correct, steps, failed, e2e, checks,
                   max(setup_peak, window_peak), tr, run_info)


# -- the faults that the correctness check has to catch (planted in the
# program; the benchmark's own runs never use them)

@contextlib.contextmanager
def fault_half_batch():
    """Half of each microbatch's tokens left out of the loss, the mean
    taken over the rest."""
    import torch.nn.functional as F
    from repro_torch.models import model

    def loss_fn(p, cfg, batch, *, remat="block", window=None):
        logits, aux = model.forward(p, cfg, batch, remat=remat,
                                    window=window)
        tokens = batch["tokens"]
        logp = F.log_softmax(logits[:, :-1], dim=-1)
        nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        nll = nll.reshape(-1)
        return nll[:nll.numel() // 2].mean() + aux

    saved = model.loss_fn
    model.loss_fn = loss_fn
    try:
        yield
    finally:
        model.loss_fn = saved


@contextlib.contextmanager
def fault_frozen():
    """Every call of the runner hands back its state unchanged."""
    from repro_torch.train import step
    saved = step.make_epoch_runner

    def make(*args, **kwargs):
        runner, meta = saved(*args, **kwargs)

        def frozen(state):
            keep = state.params.clone()
            state, losses = runner(state)
            state.params.copy_(keep)
            return state, losses
        return frozen, meta

    step.make_epoch_runner = make
    try:
        yield
    finally:
        step.make_epoch_runner = saved


FAULTS = {"half_batch": fault_half_batch, "frozen": fault_frozen}
