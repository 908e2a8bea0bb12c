"""The port's serving launcher, ``repro_torch.launch.serve``, on the CPU:
the engine on an attention arch and the legacy fallback on Mamba2,
``--obs`` records that both packages' validators
accept, the reference's flags plus ``--device``, and a run that imports
neither jax nor the reference."""
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import obs as jobs_cli
from repro.launch import serve as jserve_cli
from repro_torch.launch import obs as obs_cli
from repro_torch.launch import serve as serve_cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--reduced", "--requests", "4", "--prompt-len", "16", "--max-new",
         "4", "--width", "2", "--device", "cpu"]


def test_flags_are_the_reference_s_plus_device():
    got = vars(serve_cli.parse_args(["--arch", "qwen2-7b"]))
    want = vars(jserve_cli.parse_args(["--arch", "qwen2-7b"]))
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("arch,path", [("qwen2-7b", "engine"),
                                       ("mamba2-130m", "legacy")])
def test_serve_cli_runs_and_records(arch, path, tmp_path, capsys):
    """The acceptance command on the engine, and on an ssm arch the
    legacy fallback; the record validates under both CLIs."""
    rec = str(tmp_path / "s.jsonl")
    rep = serve_cli.main(["--arch", arch, *SMALL, "--obs", rec])
    out = capsys.readouterr().out
    assert f"[{path}] 4 requests" in out
    assert len(rep.results) == 4
    assert all(len(r.tokens) == 4 for r in rep.results)
    assert obs_cli.main(["validate", rec]) == 0
    assert jobs_cli.main(["validate", rec]) == 0
    obs_cli.main(["report", rec])
    report = capsys.readouterr().out
    assert f"serving ({path}):" in report
    assert "4 requests" in report


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_serve_cli_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "qwen2-7b", "--reduced"])


def test_serving_imports_neither_jax_nor_the_reference():
    """A served run in a fresh process, through the engine and the legacy
    loop, loads neither jax nor ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--arch', 'qwen2-7b', '--reduced', '--requests', '2', "
        "'--prompt-len', '4', '--max-new', '2', '--device', 'cpu'])\n"
        "serve.main(['--arch', 'recurrentgemma-2b', '--reduced', "
        "'--requests', '2', '--prompt-len', '4', '--max-new', '2', "
        "'--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
