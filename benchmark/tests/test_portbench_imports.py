"""Nothing the benchmark runs loads JAX, its libraries or the JAX package,
and the reference loads nothing of the program either; names are compared
by their whole top-level part (`egonn_tpu_torch` begins with `egonn_tpu`)."""
from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from benchmark.core import guard
from conftest import REPO, run_small

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def test_guard_compares_whole_top_level_names():
    names = ["egonn_tpu_torch", "egonn_tpu_torch.models", "jaxlib.xla_client", "egonn_tpu.ops",
             "jax_like", "flaxen", "optax", "orbax.checkpoint", "numpy"]
    assert guard.forbidden_modules(names) == {"jaxlib.xla_client", "egonn_tpu.ops", "optax",
                                             "orbax.checkpoint"}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    mods = _modules_after("import benchmark.reference.sparse, benchmark.reference.models, "
                          "benchmark.reference.train, benchmark.core.train_batch, "
                          "benchmark.core.scans, benchmark.core.work")
    assert not guard.forbidden_modules(mods, guard.FORBIDDEN | {"egonn_tpu_torch"})


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_loads_no_jax(small_bench, workload, capsys):
    """A whole run of each cell (at CPU sizes) ends with the guard finding
    nothing: main returns 0 and prints its result."""
    rc, result = run_small(small_bench, workload, capsys)
    assert rc == 0 and result is not None
    assert not guard.forbidden_modules(sys.modules)


def test_a_run_with_jax_loaded_prints_no_result(small_bench, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, result = run_small(small_bench, CELLS[0], capsys)
    assert rc != 0 and result is None
