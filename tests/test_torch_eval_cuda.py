"""The port's batched RANSAC on the card against the CPU, from one set of
draws (a CPU generator): transforms within 1e-4, equal inlier and match
counts, at the evaluation's sizes.  The draws themselves are device
independent, which the CPU case checks.  This module imports no JAX, so on
a machine with only torch it runs with

    python -m pytest tests/test_torch_eval_cuda.py -m cuda --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu_torch.ops.geometry import rotz
from egonn_tpu_torch.ops.ransac import draw_samples, mutual_matches, ransac_6dof


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pairs(seed, n_pairs=8, k=256, dim=128):
    """Known-transform pairs: matched keypoints share a unit descriptor, a
    quarter of cloud 2's are random; yaw to 180 deg, 10 m, noise 0.05 m."""
    gen = np.random.default_rng(seed)
    kp1 = gen.uniform(-40, 40, (n_pairs, k, 3)).astype(np.float32)
    t = np.stack([rotz(a) for a in gen.uniform(0, np.pi, n_pairs)]).astype(np.float32)
    t[:, :3, 3] = gen.uniform(-10, 10, (n_pairs, 3))
    kp2 = (np.einsum("pkj,pij->pki", kp1, t[:, :3, :3]) + t[:, None, :3, 3]
           + gen.normal(0, 0.05, kp1.shape)).astype(np.float32)
    d1 = gen.standard_normal((n_pairs, k, dim)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1.copy()
    d2[:, : k // 4] = gen.standard_normal((n_pairs, k // 4, dim))
    d2[:, : k // 4] /= np.linalg.norm(d2[:, : k // 4], axis=-1, keepdims=True)
    ones = np.ones((n_pairs, k), bool)
    return [torch.from_numpy(a) for a in (kp1, d1, ones, kp2, d2, ones)]


def test_draws_do_not_depend_on_the_valid_masks_device():
    args = _pairs(0, n_pairs=2, k=32, dim=8)
    valid = mutual_matches(args[1], args[2], args[4], args[5])[1]
    a = draw_samples(valid, 100, torch.Generator().manual_seed(5))
    b = draw_samples(valid.clone(), 100, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("n_hyp", [1024, 10240])
def test_ransac_card_matches_cpu(cuda, n_hyp):
    torch.backends.cuda.matmul.allow_tf32 = True  # ransac_6dof turns it off itself
    host = _pairs(1)
    card = [a.to(cuda) for a in host]
    got = ransac_6dof(*card, n_hypotheses=n_hyp, gen=torch.Generator().manual_seed(0))
    want = ransac_6dof(*host, n_hypotheses=n_hyp, gen=torch.Generator().manual_seed(0))
    assert float((got.transform.cpu() - want.transform).abs().max()) <= 1e-4
    assert torch.equal(got.n_inliers.cpu(), want.n_inliers)
    assert torch.equal(got.n_matches.cpu(), want.n_matches)
    assert torch.backends.cuda.matmul.allow_tf32  # restored
    torch.backends.cuda.matmul.allow_tf32 = False
