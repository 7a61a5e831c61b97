"""The harness finds a cell, a configuration, a traffic kind and a per-layer
metric by name: new files in a copy of the folder (and entries in its
BENCHMARK.json) run without an edit to any file the benchmark has.  On the
CPU the command itself exits non-zero and prints no result."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO, make_small_copy, run_small

READER = '''"""Traced calls, a number every traced run has."""


def read(ctx):
    return float(ctx.traced_calls)
'''


def test_new_files_are_found_by_name(tmp_path, capsys):
    bench = make_small_copy(tmp_path)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    # a configuration (file and adapter), a traffic kind, a cell and a metric
    cfg = json.loads((bench / "configs" / "egonn.json").read_text())
    cfg["name"] = "egonn_copy"
    (bench / "configs" / "egonn_copy.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "models" / "egonn.py", bench / "models" / "egonn_copy.py")
    shutil.copy(bench / "traffic" / "embed.py", bench / "traffic" / "embed_copy.py")
    w = json.loads((bench / "workloads" / "egonn.embed-b128.json").read_text())
    w.update(config="egonn_copy", traffic="embed_copy")
    (bench / "workloads" / "egonn_copy.embed.json").write_text(json.dumps(w))
    (bench / "metrics" / "traced_calls.copy.py").write_text(READER)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0], name="egonn_copy",
                                    file="benchmark/configs/egonn_copy.json"))
    manifest["workloads"].append(dict(name="egonn_copy.embed", config="egonn_copy",
                                      traffic="embed_copy", chips=1, why="registry test"))
    for m in manifest["end_to_end"]:
        if m["name"] == "clouds_per_s":
            m["workloads"].append("egonn_copy.embed")
    manifest["per_layer"].append(dict(name="traced_calls.copy", unit="calls", better="higher",
                                      source="host_clock", layer="device",
                                      moves="clouds_per_s", workloads=["egonn_copy.embed"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    rc, result = run_small(bench, "egonn_copy.embed", capsys, trace=0)
    assert rc == 0 and result["correct"]
    assert set(result["metrics"]) == {"clouds_per_s", "setup_s"}
    rc, result = run_small(bench, "egonn_copy.embed", capsys, trace=1)
    assert rc == 0 and result["metrics"]["traced_calls.copy"]["value"] == 2.0
    assert all(p.read_bytes() == data for p, data in before.items())


def test_the_command_refuses_a_machine_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "egonn.embed-b128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
