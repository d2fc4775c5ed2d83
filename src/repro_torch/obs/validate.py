"""Validate an obs JSONL span trace: schema + span nesting (a copy of the
JAX package's `obs/validate.py`, which is pure Python).

    python -m repro_torch.launch.control --device cpu --trace-out spans.jsonl ...
    python -m repro_torch.obs.validate spans.jsonl

Checks (the contract DESIGN.md section 14 documents):
  * every line parses as one JSON object carrying `ts`, `name`, `dur`,
    and `attrs` with the right types (`ts`/`dur` non-negative numbers,
    `name` a non-empty string, `attrs` an object);
  * spans nest properly: every non-root event's `parent` id exists, the
    child's [ts, ts+dur] interval is contained in the parent's (small
    epsilon for clock granularity), and `depth == parent.depth + 1`.
"""
from __future__ import annotations

import argparse
import json
import pathlib

REQUIRED_FIELDS = ("ts", "name", "dur", "attrs")

# Containment slack: perf_counter deltas are exact within a span, but the
# parent's t1 is read a few instructions after the child's, so allow a hair.
_EPS = 1e-6


def validate_events(records: list[dict]) -> list[str]:
    """Return human-readable schema/nesting violations (empty = valid)."""
    errors: list[str] = []
    by_id: dict = {}
    for i, rec in enumerate(records):
        where = f"event {i}"
        if not isinstance(rec, dict):
            errors.append(f"{where}: not a JSON object")
            continue
        missing = [k for k in REQUIRED_FIELDS if k not in rec]
        if missing:
            errors.append(f"{where}: missing required fields {missing}")
            continue
        if not isinstance(rec["name"], str) or not rec["name"]:
            errors.append(f"{where}: name must be a non-empty string")
        for key in ("ts", "dur"):
            v = rec[key]
            if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
                errors.append(f"{where}: {key} must be a non-negative number")
        if not isinstance(rec["attrs"], dict):
            errors.append(f"{where}: attrs must be an object")
        if "id" in rec:
            if rec["id"] in by_id:
                errors.append(f"{where}: duplicate id {rec['id']}")
            by_id[rec["id"]] = rec

    for i, rec in enumerate(records):
        if not isinstance(rec, dict) or "parent" not in rec:
            continue
        parent_id = rec["parent"]
        if parent_id == -1:
            if rec.get("depth", 0) != 0:
                errors.append(f"event {i}: root span with depth != 0")
            continue
        parent = by_id.get(parent_id)
        name = rec.get("name", "?")
        if parent is None:
            errors.append(
                f"event {i} ({name}): parent id {parent_id} not in trace"
            )
            continue
        if rec.get("depth") != parent.get("depth", 0) + 1:
            errors.append(
                f"event {i} ({name}): depth {rec.get('depth')} != "
                f"parent depth {parent.get('depth')} + 1"
            )
        child_t0, child_t1 = rec["ts"], rec["ts"] + rec["dur"]
        par_t0, par_t1 = parent["ts"], parent["ts"] + parent["dur"]
        if child_t0 < par_t0 - _EPS or child_t1 > par_t1 + _EPS:
            errors.append(
                f"event {i} ({name}): interval [{child_t0:.6f}, "
                f"{child_t1:.6f}] not contained in parent "
                f"{parent.get('name', '?')} [{par_t0:.6f}, {par_t1:.6f}]"
            )
    return errors


def validate_lines(lines) -> tuple[list[dict], list[str]]:
    """Parse JSONL lines; returns (parsed_records, errors)."""
    records: list[dict] = []
    errors: list[str] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as exc:
            errors.append(f"line {i + 1}: invalid JSON ({exc})")
    return records, errors + validate_events(records)


def validate_file(path) -> tuple[int, list[str]]:
    """Returns (n_events, errors) for one JSONL trace file."""
    text = pathlib.Path(path).read_text()
    records, errors = validate_lines(text.splitlines())
    return len(records), errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="path to a JSONL span trace")
    ap.add_argument(
        "--min-events",
        type=int,
        default=1,
        help="fail unless the trace holds at least this many events",
    )
    args = ap.parse_args(argv)
    n_events, errors = validate_file(args.trace)
    if n_events < args.min_events:
        errors.append(
            f"trace has {n_events} events, expected >= {args.min_events}"
        )
    if errors:
        for err in errors:
            print(f"INVALID: {err}")
        return 1
    print(f"{args.trace}: {n_events} events, schema + nesting OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
