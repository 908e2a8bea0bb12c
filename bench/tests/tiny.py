"""The benchmark's cells cut to sizes a CPU test run can hold: the same
kinds, references, limits and faults, at small widths. Besides the
cells of ``BENCHMARK.json``, the LM cell whose harness is ready
(``LM_CELL``): its files are read directly."""
import dataclasses

from bench.harness import cells

LM_CELL = "qwen2-7b-l4.cvr-s1k"
LM = {"hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 4,
      "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512}
LM_TRAFFIC = {"seq": 32, "microbatch": 1, "accum": 2}
CONVEX = {"rows_per_worker": 60, "features": 12}
CONVEX_TRAFFIC = {"workers": 4, "rounds": 3, "order_sets": 2}


def _lm_cell() -> cells.Cell:
    config, traffic = LM_CELL.split(".", 1)
    return cells.Cell(
        name=LM_CELL, chips=1,
        config=cells.load_json(cells.BENCH / "configs" / f"{config}.json"),
        traffic=cells.load_json(cells.BENCH / "traffic" / f"{traffic}.json"),
        limits=cells.load_json(cells.BENCH / "limits" / f"{LM_CELL}.json"),
        end_to_end=[], per_layer=[])


def cell(name: str) -> cells.Cell:
    c = _lm_cell() if name == LM_CELL else cells.cell(name)
    if c.config["kind"] == "lm_train":
        return dataclasses.replace(c, config=dict(c.config, **LM),
                                   traffic=dict(LM_TRAFFIC))
    return dataclasses.replace(c, config=dict(c.config, **CONVEX),
                               traffic=dict(CONVEX_TRAFFIC))


def names():
    """The cells of ``BENCHMARK.json``, and the ready LM cell."""
    listed = [w["name"] for w in cells.spec()["workloads"]]
    return listed + ([LM_CELL] if LM_CELL not in listed else [])
