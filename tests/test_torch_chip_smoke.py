"""chip_smoke.py's phase 11(d) comparison (`epoch_stats_agree`) on
hand-written epoch records: do_train on a mesh against one process."""
import pytest

import torch_threads  # noqa: F401  (caps this worker's torch threads)
import chip_smoke

PAIRS, STEPS = 8, {"train": 5, "val": 1}


def _record(epoch: int, **changed) -> dict:
    """One epoch line of the metrics log: every listed stat 1.0, the counts
    at plausible values, `changed` ({"train_<stat>": value}) applied."""
    stats = dict.fromkeys(chip_smoke.DP_CONTINUOUS_STATS, 1.0)
    stats.update(num_triplets=32.0, num_non_zero_triplets=20.0, matching_keypoints=56.0,
                 matching_descriptors=1.9, kp_per_cloud=300.0)
    out = {"epoch": epoch, "steps": dict(STEPS)}
    for phase in STEPS:
        out[phase] = dict(stats)
        out[phase].update({k[len(phase) + 1:]: v for k, v in changed.items()
                           if k.startswith(phase + "_")})
    return out


@pytest.mark.parametrize("mesh_epoch2, mesh_epoch1, ok", [
    # one descriptor match in 40 (8 pairs x 5 steps) flipped in epoch 2
    pytest.param({"train_matching_descriptors": 1.875}, {}, True, id="one-flip"),
    pytest.param({"train_matching_descriptors": 1.85}, {}, False, id="two-flips"),
    pytest.param({}, {"train_correspondence_loss": 1.0002}, False, id="continuous-2e-4"),
    pytest.param({}, {}, True, id="equal"),
])
def test_epoch_stats_agree(mesh_epoch2, mesh_epoch1, ok):
    one = [_record(1), _record(2)]
    mesh = [_record(1, **mesh_epoch1), _record(2, **mesh_epoch2)]
    assert chip_smoke.epoch_stats_agree(mesh, one, PAIRS)["ok"] is ok
