"""``BENCHMARK.json`` against the benchmark's contract, and each cell's
files found by name."""
import json
import re

import pytest

from bench.harness import cells
from bench.tests import tiny

SPEC = cells.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (cells.ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in paths), w


def test_run_seconds_fits_the_full_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells_max = 24
    runs = 2 + 14 * cells_max
    assert runs * (rs + 60) + cells_max * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    all_names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in
                       c["reduced"] if k != "vocab_size")
        all_names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names)), group
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        c = cells.cell(w["name"])
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert c.per_layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert m["moves"] in {x["name"] for x in cells.cell(w).end_to_end}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_no_cell_asks_for_four_chips():
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_configs_are_used_and_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(name):
    c = cells.cell(name)
    assert c.module.run and c.module.readings and c.module.FAULTS
    assert set(c.limits) >= set(_checked_numbers(c))
    for m in c.per_layer:
        reader = cells.metric_reader(m["name"])
        assert callable(reader.read)


def _checked_numbers(c):
    return {"lm_train": ("loss_gap_first2", "grad_gap", "change_gap",
                         "change_gap_median"),
            "convex_sync": ("x_gap", "rel_gap")}[c.config["kind"]]


def test_lm_harness_files_are_found():
    c = tiny.cell(tiny.LM_CELL)
    assert set(c.limits) >= set(_checked_numbers(c))
    for name in ("mfu_pct.train_step", "roofline_pct.k1_vr_update",
                 "roofline_pct.k3_flash_fwd", "device_idle_pct.train"):
        assert callable(cells.metric_reader(name).read)


def test_reduced_keys_differ_from_the_source_only():
    conf = cells.load_json(cells.BENCH / "configs" / "qwen2-7b-l4.json")
    # Qwen2-7B's published widths (Qwen/Qwen2-7B config.json)
    published = {"hidden_size": 3584, "intermediate_size": 18944,
                 "num_attention_heads": 28, "num_key_value_heads": 4,
                 "vocab_size": 152064, "rope_theta": 1000000.0,
                 "rms_norm_eps": 1e-06, "num_hidden_layers": 28,
                 "tie_word_embeddings": False, "initializer_range": 0.02}
    changed = {k for k, v in published.items() if conf[k] != v}
    assert changed == {"num_hidden_layers"}
