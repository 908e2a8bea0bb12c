"""The telemetry row schema, pinned — the port's copy of
``repro/obs/schema.py``, at the same ``SCHEMA_VERSION``, so a record
either package writes validates under the other's validator.

Every JSONL row a :class:`~repro_torch.obs.recorder.Recorder` writes must
carry the base fields plus its kind's required fields.
``tests/test_torch_obs.py`` pins this row schema and the
``RunResult.provenance()`` row shape (:data:`PROVENANCE_KEYS` /
:data:`PROVENANCE_SPEC_KEYS`): silently dropping or renaming a field
would corrupt every consumer of the rows without failing anything, so
fail loudly here instead.
"""
from __future__ import annotations

import json
from typing import Iterable

from repro_torch.obs.recorder import SCHEMA_VERSION

# base fields every row carries
BASE_FIELDS = ("v", "run", "t", "kind", "name")

# per-kind required fields (beyond the base)
KIND_FIELDS = {
    "event": (),
    "metric": ("step", "value"),
    "span": ("t0", "dur_s"),
}

# RunResult.provenance() row shape. The reference's keys, with its
# ``traces`` (jit retrace counts) replaced by the port's ``launches`` (the
# hand-written kernels' launches by name) and ``device`` (where it ran).
# Adding a field means updating these tuples (and the pinning test)
# deliberately; removing/renaming one fails the suite.
PROVENANCE_KEYS = ("spec", "final_rel", "rels_tail", "rounds_recorded",
                   "wall_s", "launches", "device", "comms", "staleness",
                   "schema_v")
PROVENANCE_SPEC_KEYS = ("algo", "p", "eta", "rounds", "backend", "fetch",
                        "speeds", "tau", "seed", "metric_every", "sampling",
                        "decay", "fused", "topology", "elastic", "prox",
                        "snapshot")

# Elastic membership events: the required payload of each named event,
# pinned so a captured dropout run validates structurally.
EVENT_FIELDS = {
    "worker_lost": ("worker", "round", "detect_s"),
    "worker_joined": ("worker", "round"),
    "repartition": ("round", "p_old", "p_new", "survivors"),
}


class SchemaError(ValueError):
    """A telemetry row that does not conform to the pinned schema."""


def validate_row(row: dict) -> dict:
    """Check one decoded row; returns it (for chaining) or raises
    :class:`SchemaError` naming the violation."""
    if not isinstance(row, dict):
        raise SchemaError(f"row is not an object: {row!r}")
    missing = [k for k in BASE_FIELDS if k not in row]
    if missing:
        raise SchemaError(f"row missing base fields {missing}: {row!r}")
    if row["v"] != SCHEMA_VERSION:
        raise SchemaError(
            f"row schema version {row['v']!r} != {SCHEMA_VERSION}")
    kind = row["kind"]
    if kind not in KIND_FIELDS:
        raise SchemaError(f"unknown row kind {kind!r}: {row!r}")
    missing = [k for k in KIND_FIELDS[kind] if k not in row]
    if missing:
        raise SchemaError(
            f"{kind} row missing required fields {missing}: {row!r}")
    if kind == "span" and not isinstance(row["dur_s"], (int, float)):
        raise SchemaError(f"span dur_s is not a number: {row!r}")
    if kind == "metric" and not isinstance(row["value"], (int, float)):
        raise SchemaError(f"metric value is not a number: {row!r}")
    if kind == "event" and row["name"] in EVENT_FIELDS:
        missing = [k for k in EVENT_FIELDS[row["name"]] if k not in row]
        if missing:
            raise SchemaError(
                f"{row['name']} event missing required fields {missing}: "
                f"{row!r}")
    return row


def validate_rows(rows: Iterable[dict]) -> int:
    n = 0
    for row in rows:
        validate_row(row)
        n += 1
    if n == 0:
        raise SchemaError("run record has no rows")
    return n


def load_rows(path: str) -> list:
    """Decode a JSONL run record (no validation; see
    :func:`validate_file`)."""
    rows = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{lineno}: not JSON ({e})") from None
    return rows


def validate_file(path: str) -> int:
    """Validate a JSONL run record end to end; returns the row count."""
    return validate_rows(load_rows(path))
