"""`minkloc3dv2.train-b2048` at CPU sizes: its files load by name, the sound
program passes every limit, and each fault of `staged_controls.FAULTS`
planted in the program fails at least one (the cell run whole, past the
harness's look for a card, with the configuration's split cut so that a
batch holds two chunks)."""
from __future__ import annotations

import json

import pytest

from benchmark import staged_controls
from benchmark.core import runner
from conftest import make_small_copy, run_small

CELL = "minkloc3dv2.train-b2048"


@pytest.fixture(scope="module")
def staged_bench(tmp_path_factory):
    bench = make_small_copy(tmp_path_factory.mktemp("staged"))
    path = bench / "configs" / "minkloc3dv2_oxford.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["capacities"] = [2048, 2048, 1536, 896, 384]
    cfg["train"]["batch_split_size"] = 4
    path.write_text(json.dumps(cfg))
    return bench


def test_cell_loads_by_name(staged_bench):
    workload, cfg, adapter, traffic = runner.load_cell(staged_bench, CELL)
    assert workload["traffic"] == "staged_train" and cfg["name"] == "minkloc3dv2_oxford"
    assert adapter.OUTPUTS == ("global",) and hasattr(traffic, "run")
    assert set(workload["limits"]) == {"embed_gap", "grad_gap", "stats1_gap", "change_gap",
                                       "dropped_voxels"}
    full = json.loads((runner.BENCH_DIR / "workloads" / f"{CELL}.json").read_text())
    p = full["traffic_params"]
    full_cfg = json.loads((runner.BENCH_DIR / "configs" / "minkloc3dv2_oxford.json").read_text())
    assert p["places"] * p["scans_per_place"] == full_cfg["train"]["batch_size"] == 2048
    assert full_cfg["train"]["batch_split_size"] == 128 and full_cfg["reduced"] == []


def test_sound_program_is_correct(staged_bench, capsys):
    rc, result = run_small(staged_bench, CELL, capsys)
    assert rc == 0 and result["correct"], result["checks"]
    assert result["checks"]["dropped_voxels"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(staged_controls.FAULTS))
def test_fault_is_not_correct(staged_bench, fault, capsys):
    with staged_controls.FAULTS[fault]():
        rc, result = run_small(staged_bench, CELL, capsys)
    assert rc == 0 and not result["correct"], result["checks"]
