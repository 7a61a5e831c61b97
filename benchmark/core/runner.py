"""The harness: one run of one cell, driven by `BENCHMARK.json` and the files
found by name under `benchmark/`:

    workloads/<cell>.json      config, traffic kind, traffic parameters, limits
    configs/<config>.json      the configuration's sizes
    models/<config>.py         the program's model and the reference's
    traffic/<kind>.py          set-up, window, comparison (`run(cell)`)
    metrics/<metric>.py        a per-layer reader (`read(ctx)`)

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics.  The last line of standard output is
the result: {correct, attempted, failed, metrics, device[, breakdown],
checks}; `checks` holds each number compared beside its limit, and the same
lines end standard error.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from benchmark.core import guard
from benchmark.core.cell import Cell, scratch_dir
from benchmark.core.layers import LayerContext
from benchmark.core.trace import breakdown

BENCH_DIR = Path(__file__).resolve().parents[1]


def load_module(path: Path, kind: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    name = f"portbench_{kind}_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


def load_cell(bench_dir: Path, name: str) -> tuple:
    """(workload, configuration, model adapter, traffic module) of a cell,
    found by name."""
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    config = workload["config"]
    return (workload, load_json(bench_dir / "configs" / f"{config}.json"),
            load_module(bench_dir / "models" / f"{config}.py", "model"),
            load_module(bench_dir / "traffic" / f"{workload['traffic']}.py", "traffic"))


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"{name} is not a workload of BENCHMARK.json")


def metrics_of(entries, name: str, reported=None):
    """The metric entries this cell reports: those listing it, or those
    without a list whose `moves` metric (per-layer) it reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench_dir: Path, bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float) -> dict:
    workload, cfg, adapter, traffic = load_cell(bench_dir, name)
    if workload["config"] != cell_entry(bench, name)["config"]:
        raise ValueError(f"{name}: config {workload['config']} differs from BENCHMARK.json's")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = Cell(name, workload, cfg, adapter, seed, seconds, trace, device, t_start,
                scratch_dir(str(bench_dir.parent)))
    out = traffic.run(cell)
    trace_read = cell.tracer.read() if cell.tracer else None

    limits = workload["limits"]
    missing = set(out.checks) ^ set(limits)
    if missing:
        raise KeyError(f"{name}: compared numbers and limits differ in {sorted(missing)}")
    correct = all(out.checks[k] <= limits[k] for k in limits)

    e2e = metrics_of(bench["end_to_end"], name)
    if not trace:
        values = dict(out.e2e, setup_s=cell.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    else:
        ctx = LayerContext(trace_read, out.traced_calls, out.traced_records)
        metrics = {}
        for m in metrics_of(bench["per_layer"], name, {x["name"] for x in e2e}):
            value = load_module(bench_dir / "metrics" / f"{m['name']}.py", "metric").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info(device, cell)}
    if trace_read is not None and trace_read.kernels:
        result["breakdown"] = breakdown(trace_read)
    result["checks"] = {k: {"value": out.checks[k], "limit": limits[k]} for k in limits}
    return result


def device_info(device: torch.device, cell: Cell) -> dict:
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": cell.peak_bytes}
    tr = cell.tracer.trace if cell.tracer else None
    if tr is not None:
        info["busy_s"] = tr.busy_seconds()
        info["window_s"] = tr.seconds
    return info


def main(argv, t_start: float, device: Optional[torch.device] = None,
         bench_dir: Path = BENCH_DIR) -> int:
    """The command line.  `device` None: the first CUDA card, required; a
    test may hand the CPU, and another copy of the benchmark's folder."""
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(bench_dir.parent / "BENCHMARK.json")
    chips = cell_entry(bench, args.workload)["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        print(f"card: {power_limit()}", file=sys.stderr)
    os.environ.setdefault("USE_FLAX", "0")
    result = run_cell(bench_dir, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t_start)
    found = guard.forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {sorted(found)}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
