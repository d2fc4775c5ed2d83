"""The benchmark's machinery, shared by every cell: it finds a cell's
configuration, traffic, limits, driver and per-layer readers by the names
in `BENCHMARK.json`, times set-up and the window, reduces the profiler's
timeline, runs the reference's judgement and assembles the result line.

What belongs to one configuration, traffic mix, cell or per-layer metric
lives in a file of its own (bench/README.md), so a later cell, mix or
metric is added as files and an entry in `BENCHMARK.json`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that may not be loaded in a benchmark process:
# the JAX stack and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """Import a driver or metric reader from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`repro_torch` is not `repro`)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with everything the harness finds for it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    def driver(self):
        return load_module(self.root / "bench" / "drivers" / f"{self.traffic['driver']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "bench" / "metrics" / f"{metric}.py")


def _for_cell(metrics: list, cell: str, moves_ok=None) -> list:
    out = []
    for m in metrics:
        listed = m.get("workloads")
        if listed is not None and cell not in listed:
            continue
        if listed is None and moves_ok is not None and m["moves"] not in moves_ok:
            continue
        out.append(m)
    return out


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files loaded."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "bench" / "workloads" / f"{name}.json")
    e2e = _for_cell(bench["end_to_end"], name)
    per_layer = _for_cell(bench["per_layer"], name, moves_ok={m["name"] for m in e2e})
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer, root=root)


def seed_rng(seed: int, stream: int = 0) -> np.random.Generator:
    """One of the run's generators: any whole number, negative or past 64
    bits too; `stream` 0 draws the inputs, the others what a driver picks."""
    return np.random.default_rng((int(seed) % 2**64, stream))


def input_seed(seed: int) -> int:
    """The seed the run's networks are drawn from, below 2**31 as the
    generators' own seeds are."""
    return int(seed_rng(seed).integers(0, 2**31 - 2**16))


# --------------------------------------------------------------------------
# The device timeline
# --------------------------------------------------------------------------
def _union_length(intervals) -> tuple[float, list, list]:
    """Total length covered by (start, end) intervals, the gaps between
    them and the merged intervals, each as (start, end)."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    return busy, gaps, merged


def _events(prof):
    """(name, is_device, is_annotation, start_ns, end_ns) of every event."""
    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            dev = "CUDA" in str(e.device_type())
            out.append((e.name(), dev, bool(e.is_user_annotation()), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    except AttributeError:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.events():
            out.append((e.name, e.device_type == cuda, False, e.time_range.start * 1000,
                        e.time_range.end * 1000))
    return out


def reduce_profile(prof, span_prefixes=("solve_fleet.", "control.")) -> dict:
    """Device busy seconds, the traced window's length, the device
    operations that took most time and the idle time by the innermost
    benchmark or program span the host was in. The window runs from the
    first host event to the last device or host event of the capture."""
    # Spans are annotations on the device's timeline too: not device work.
    ev = [(n, d, a, s, e) for (n, d, a, s, e) in _events(prof)
          if not (d and (a or n.startswith(span_prefixes)))]
    dev = [(s, e) for (n, d, _, s, e) in ev if d and e > s]
    host = [(s, e) for (n, d, _, s, e) in ev if not d]
    spans = sorted([(s, e, n) for (n, d, _, s, e) in ev
                    if not d and n.startswith(span_prefixes)], key=lambda x: (x[0], -x[1]))
    if not dev or not host:
        return {}
    t0 = min(s for s, _ in host)
    t1 = max(max(e for _, e in dev), max(e for _, e in host))
    busy, gaps, merged = _union_length(dev)
    gaps = [(t0, merged[0][0])] + gaps + [(merged[-1][1], t1)]
    by_op: dict = {}
    for (n, d, _, s, e) in ev:
        if d:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    idle_by: dict = {}
    for gs, ge in gaps:
        if ge <= gs:
            continue
        label = "outside any span"
        for s, e, n in spans:
            if s <= gs < e:
                label = n  # later starts are inner spans
        idle_by[label] = idle_by.get(label, 0.0) + (ge - gs) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9, "device_ops": top(by_op),
            "idle_gaps": top(idle_by)}


class Profiler:
    """Starts and stops a torch.profiler capture of host and device
    activity around the part of the window a driver chooses; idle on runs
    without `--trace 1`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.done = False

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.done = True

    def summary(self) -> dict:
        return reduce_profile(self.prof) if self.done else {}


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Run:
    """What a driver is handed: the cell, the run's arguments, the device
    and the profiler; `t_start` is the process's start on the host clock."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    profiler: Profiler


def judge_answer(nets: list, x, phi, J, hosts, limits: dict, numbers: dict,
                 base: list | None = None) -> list:
    """Judge one stacked answer with the reference; fold its numbers into
    `numbers` (the largest reading of each) and return its per-network rows.
    Every number but `unimproved`, a share of the batch, is per network;
    `base` as `judge_fleet` takes it."""
    from reference import judge as ref

    rows, share = ref.judge_fleet(nets, x, phi, J, hosts, base)
    numbers["unimproved"] = max(numbers.get("unimproved", 0.0), share)
    for k in limits:
        if k != "unimproved":
            numbers[k] = max(numbers.get(k, 0.0), max(row[k] for row in rows))
    return rows


def judged_lanes(run, n_lanes: int) -> np.ndarray:
    """The lanes of a batch whose answers a run judges: all of them, or
    the traffic's `judge_lanes` drawn from the seed where the batch is
    larger."""
    k = int(run.cell.traffic.get("judge_lanes", n_lanes))
    if k >= n_lanes:
        return np.arange(n_lanes)
    return np.sort(seed_rng(run.seed, 2).choice(n_lanes, size=k, replace=False))


def failing(rows: list, limits: dict) -> int:
    """Networks of one judged answer that pass one of their limits."""
    return sum(any(row[k] > limits[k] for k in limits if k in row) for row in rows)


def _checks(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Each limited number beside its limit; a number never read fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        out[name] = {"value": value, "limit": limit}
    return out, ok


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             root: Path = ROOT, t_start: float | None = None) -> dict:
    """Set up, measure and judge one run of cell `name`; return the result
    line as a dict (without printing it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    cell = find_cell(name, root)
    dev = torch.device(device)
    run = Run(cell=cell, seed=seed, seconds=float(seconds), trace=trace, device=dev,
              t_start=t_start, profiler=Profiler(trace))
    drv = cell.driver()
    state = drv.setup(run)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    from repro_torch.obs import trace as obs_trace
    if trace:
        obs_trace.configure(enabled=True)
        obs_trace.reset()
    record = drv.window(run, state)
    run.profiler.stop()
    spans = obs_trace.TRACER.events() if trace else []
    obs_trace.configure(enabled=False)

    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    t_judge = time.perf_counter()
    numbers, attempted, failed = drv.judge(run, state, record)
    print(f"bench: judged in {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    checks, ok = _checks(numbers, cell.limits)
    correct = ok and failed == 0 and attempted > 0

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed)}
    if trace:
        prof = run.profiler.summary()
        reading = {"cell": cell, "record": record, "spans": spans, "profile": prof, "state": state}
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        if prof:
            device_info["busy_s"] = prof["busy_s"]
            device_info["window_s"] = prof["window_s"]
        result["device"] = device_info
        if prof:
            result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    else:
        values = dict(drv.end_to_end(run, state, record), setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end if values.get(m["name"]) is not None}
        # A run that could not measure one of its metrics is no sound run.
        result["correct"] &= len(result["metrics"]) == len(cell.end_to_end)
        result["device"] = device_info
    result["checks"] = checks
    return result
