"""The port's examples (``repro_torch.examples``) on the CPU at small
sizes: each runs through its ``main`` (or the functions it calls), makes
its own claim (CentralVR below SGD, the training loss falling), keeps the
reference script's flags and adds ``--device``, and loads neither jax nor
the reference.
"""
import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.examples import (convex_distributed, quickstart,
                                  serve_batched, train_centralvr_100m)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("quickstart", "convex_distributed", "serve_batched",
         "train_centralvr_100m")
CPU = torch.device("cpu")


def _flags(path):
    return set(re.findall(r'add_argument\("(--[\w-]+)"', open(path).read()))


@pytest.mark.parametrize("name", NAMES)
def test_flags_are_the_reference_s_plus_device(name):
    ref = _flags(os.path.join(ROOT, "examples", f"{name}.py"))
    port = _flags(os.path.join(ROOT, "src", "repro_torch", "examples",
                               f"{name}.py"))
    assert port == ref | {"--device"}


def test_examples_load_neither_jax_nor_the_reference():
    code = ("import sys\n"
            + "".join(f"import repro_torch.examples.{n}\n" for n in NAMES)
            + "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
              "or m.startswith(('jax.', 'repro.'))]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_quickstart_centralvr_beats_sgd_and_the_lm_trains():
    cvr, sgd = quickstart.convex_demo(CPU)
    assert len(cvr) == len(sgd) == 12
    assert cvr[-1] < sgd[-1]
    res = quickstart.lm_demo(CPU, steps=8)
    assert len(res.losses) == 8 and res.losses[-1] < res.losses[0]


def test_quickstart_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])


@pytest.mark.parametrize("backend", ["vmap", "spmd"])
def test_convex_distributed_runs_every_driver(backend):
    """Every row runs; on the spmd ranks, Algorithm 2 runs the vmap run's
    arithmetic: the same final rel on the same seed (float32)."""
    argv = ["--workers", "4", "--n-per-worker", "60", "--d", "8",
            "--rounds", "4", "--device", "cpu"]
    out = convex_distributed.main(argv + ["--backend", backend])
    table = [k for k in out["rows"] if not k.startswith("weak")]
    assert len(table) == 7 and set(out["weak"]) == {2, 4}
    for final, wall in out["rows"].values():
        assert 0 <= final < 1 and wall >= 0
    if backend == "spmd":
        vmap = convex_distributed.main(argv)["rows"]
        for name in ("CentralVR-Sync", "weak p=2", "weak p=4"):
            assert out["rows"][name][0] == pytest.approx(vmap[name][0],
                                                         rel=1e-5)


def test_serve_batched_takes_the_engine_and_the_legacy_loop(capsys):
    out = serve_batched.main(["--device", "cpu"])
    assert {a: r["path"] for a, r in out.items()} == {
        "qwen2-7b": "engine", "mamba2-130m": "legacy",
        "recurrentgemma-2b": "legacy"}
    for r in out.values():
        assert r["summary"]["requests"] == 6
        assert all(len(t) >= 1 for t in r["tokens"])
    assert "engine" in capsys.readouterr().out


def test_train_centralvr_100m_profiles_and_a_small_run(tmp_path,
                                                        monkeypatch):
    full, small = (train_centralvr_100m.model_cfg(f) for f in (True, False))
    assert (full.head_dim, small.head_dim) == (64, 40)
    assert 90e6 < full.param_count() < 110e6
    tiny = dataclasses.replace(small, num_layers=2, d_model=64,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               d_ff=128, vocab_size=256)
    monkeypatch.setattr(train_centralvr_100m, "model_cfg",
                        lambda full: tiny)
    ck = tmp_path / "ck.npz"
    out = train_centralvr_100m.main(["--steps", "16", "--checkpoint",
                                     str(ck), "--device", "cpu"])
    assert len(out["losses"]) == 16 and out["losses"][-1] < out["losses"][0]
    assert ck.exists()
