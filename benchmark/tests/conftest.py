"""Fixtures of the benchmark's tests: a small copy of the benchmark's folder
for CPU runs, and the card for the tests marked `cuda`.

    python -m pytest benchmark/tests -q                      # CPU (cuda ones skip)
    python -m pytest benchmark/tests -q -m cuda -p no:cacheprovider   # on the card
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# CPU-sized traffic: the cells' files with their sizes cut, nothing else changed
SMALL_TRAFFIC = dict(batch=2, points=2048, places=2, pairs=2, warmup_calls=1, trace_after=1,
                     trace_calls=2, trace_steps=1)
SMALL_CAP0 = {"egonn": 1024, "minkloc3d_mulran": 2048}


def make_small_copy(dst: Path) -> Path:
    """dst/benchmark (a copy of the folder at CPU sizes) and dst/BENCHMARK.json;
    returns the copy's benchmark folder."""
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    bench = dst / "benchmark"
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["model"]["cap0"] = SMALL_CAP0[cfg["name"]]
        path.write_text(json.dumps(cfg))
    for path in (bench / "workloads").glob("*.json"):
        w = json.loads(path.read_text())
        t = w["traffic_params"]
        for k, v in SMALL_TRAFFIC.items():
            if k in t:
                t[k] = v
        path.write_text(json.dumps(w))
    return bench


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory) -> Path:
    return make_small_copy(tmp_path_factory.mktemp("portbench"))


def run_small(bench_dir: Path, workload: str, capsys, seed: int = 5, seconds: float = 1.0,
              trace: int = 0) -> tuple:
    """(exit code, the result line parsed or None) of a CPU run."""
    from benchmark.core import runner

    capsys.readouterr()
    rc = runner.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)], time.perf_counter(),
                     device=torch.device("cpu"), bench_dir=bench_dir)
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
