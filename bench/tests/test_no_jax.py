"""No module that the benchmark runs has the top-level name jax, jaxlib,
flax or repro (the JAX package): the harness, every metric reader and the
check of each tiny cell, in a fresh process."""
import json
import subprocess
import sys

from bench.harness import cells

SCRIPT = r"""
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
from bench import run
from bench.harness import cells
from bench.tests import tiny
for path in sorted((cells.BENCH / "metrics").glob("*.py")):
    cells.metric_reader(path.stem)
for name in tiny.names():
    t = tiny.cell(name)
    t.module.readings(t, 1, torch.device("cpu"))
print(json.dumps(run.forbidden_modules()))
"""


def test_no_jax_module_is_loaded():
    code = SCRIPT.format(src=str(cells.ROOT / "src"), root=str(cells.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd=cells.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    assert "repro_torch" in {m.split(".")[0] for m in _loaded(code)}


def _loaded(code):
    probe = code.replace("print(json.dumps(run.forbidden_modules()))",
                         "print(json.dumps(sorted(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, timeout=900, cwd=cells.ROOT)
    return json.loads(p.stdout.strip().splitlines()[-1])
