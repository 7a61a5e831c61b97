"""Port vs JAX: capacity calibration (`sparse/calibrate.py`) on the same
`lidar_sim` clouds, at a small cap0: the fitted table bit-equal, also where
a level truncates and the fit has to measure again."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse.calibrate import calibrate_capacities as j_calibrate
from egonn_tpu.sparse.pyramid import egonn_pyramid_spec as j_spec
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse.calibrate import (
    calibrate_capacities,
    load_calibration,
    save_calibration,
)
from egonn_tpu_torch.sparse.pyramid import egonn_pyramid_spec

STEPS = [1.0, 0.3, 0.2]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def sample():
    clouds = lidar_scan_clouds(3, 4096, seed=0)
    mask = np.ones(clouds.shape[:2], bool)
    mask[1, 3000:] = False
    return clouds, mask


@pytest.mark.parametrize("truncating", [False, True])
def test_calibrate_capacities_equals_jax(sample, truncating):
    """At cap0 2048 the default table fits L1 (truncating False); squeezed
    to 256 at L1-L3, L1 truncates, so L2 and below see only the kept voxels
    until the fit grows L1 and measures again."""
    clouds, mask = sample
    t_spec, j_sp = egonn_pyramid_spec(cap0=2048), j_spec(cap0=2048)
    assert t_spec.capacities == j_sp.capacities
    if truncating:
        caps = (2048, 256, 256, 256) + t_spec.capacities[4:]
        t_spec = dataclasses.replace(t_spec, capacities=caps)
        j_sp = dataclasses.replace(j_sp, capacities=caps)
    got = calibrate_capacities(clouds, mask, PolarQuantizer(STEPS), t_spec, batch=2, device=CPU)
    want = j_calibrate(clouds, mask, JPolar(STEPS), j_sp, batch=2)
    assert got == tuple(want)
    assert got[0] == 2048 and got != t_spec.capacities
    if truncating:  # a single round would have kept L2 at what a truncated L1 shows
        one_round = calibrate_capacities(clouds, mask, PolarQuantizer(STEPS), t_spec, batch=2,
                                         max_rounds=1, device=CPU)
        assert one_round[1] > 256 and one_round != got


def test_calibration_round_trip(tmp_path):
    table = {"cap_L1": 1024, "cap_L2": 512, "zrun_L0": 384}
    path = str(tmp_path / "calib.json")
    save_calibration(table, path)
    assert load_calibration(path) == table
