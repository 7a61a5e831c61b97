"""On the card: each cell's control fails its comparison while the sound
program passes it, at the cell's own sizes and inputs (`control.py`).  The
controls: the reference in the program's place with TF32 matmuls (the
precision below the configurations' f32), the program with bf16
activations (`EGONN_BF16_ACTS=1`) and, for training, half of the batch left
out and the gather convs' weight gradients doubled or negated.

    python -m pytest benchmark/tests/test_portbench_control.py -m cuda -p no:cacheprovider
"""
from __future__ import annotations

import json

import pytest

from benchmark import control
from conftest import REPO

BENCH = REPO / "benchmark"
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_controls_fail_and_the_program_passes(cuda, workload):
    limits = json.loads((BENCH / "workloads" / f"{workload}.json").read_text())["limits"]
    readings = control.readings(BENCH, workload, 3000000999, cuda)
    readings.pop("look", None)  # not a control: what the look reads
    if readings.get("program_bf16") == readings["program"]:
        del readings["program_bf16"]  # the flag does not reach this model (MinkLoc)
    over = {name: sorted(k for k in limits if values[k] > limits[k])
            for name, values in readings.items()}
    assert over.pop("program") == [], readings["program"]
    assert "tf32" in over and all(over.values()), readings
