"""Port vs JAX: the evaluation's ops (geometry and pose conventions, Kabsch,
mutual matching, batched RANSAC, device top-k, ICP) on the same numpy
inputs.  RANSAC's draws cannot share a stream, so the JAX draws are
recomputed here (the `jax.random.split` / `jax.random.choice` calls of
`egonn_tpu/ops/ransac.py`) and handed to the port as `samples`.  The card
against the CPU is in tests/test_torch_eval_cuda.py (no JAX)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.ops import geometry as jg
from egonn_tpu.ops import icp as ji
from egonn_tpu.ops.knn import topk_l2 as j_topk_l2
from egonn_tpu.ops.ransac import kabsch as j_kabsch
from egonn_tpu.ops.ransac import mutual_matches as j_mutual_matches
from egonn_tpu.ops.ransac import ransac_6dof as j_ransac
from egonn_tpu_torch.ops import geometry as tg
from egonn_tpu_torch.ops import icp as ti
from egonn_tpu_torch.ops.knn import topk_l2
from egonn_tpu_torch.ops.ransac import draw_samples, kabsch, mutual_matches, ransac_6dof

CPU = torch.device("cpu")


def _pose(rng):
    m = jg.rotz(rng.uniform(-np.pi, np.pi))
    m[:3, 3] = rng.uniform(-50, 50, 3)
    return m


def make_pair(rng, k=96, n_outliers=24, noise=0.05, dim=16, max_angle=np.pi, max_t=5.0):
    """tests/test_ransac.py's known-transform pair: matched keypoints share a
    unit descriptor, the first n_outliers of cloud 2 get random ones."""
    kp1 = rng.uniform(-40, 40, (k, 3)).astype(np.float32)
    t = jg.rotz(rng.uniform(0, max_angle)).astype(np.float32)
    t[:3, 3] = rng.uniform(-max_t, max_t, 3)
    kp2 = (kp1 @ t[:3, :3].T + t[:3, 3] + rng.normal(0, noise, (k, 3))).astype(np.float32)
    d = rng.standard_normal((k, dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d2 = d.copy()
    d2[:n_outliers] = rng.standard_normal((n_outliers, dim))
    d2[:n_outliers] /= np.linalg.norm(d2[:n_outliers], axis=1, keepdims=True)
    return kp1, d, kp2, d2, t


def jax_draws(key, valid, n_hypotheses):
    """JAX's hypothesis draws for one pair, as `ransac_6dof` makes them."""
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)
    k1 = valid.shape[0]
    keys = jax.random.split(key, n_hypotheses)
    return np.array(jax.vmap(
        lambda k: jax.random.choice(k, k1, shape=(3,), replace=False, p=probs))(keys),
        dtype=np.int64)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_pose_conventions_match_jax(rng):
    for _ in range(4):
        m1, m2 = _pose(rng), _pose(rng)
        for name in ("relative_pose", "mulran_relative_pose", "kitti_relative_pose"):
            np.testing.assert_allclose(getattr(tg, name)(m1, m2), getattr(jg, name)(m1, m2),
                                       rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tg.KITTI_VELO2CAM, jg.KITTI_VELO2CAM)
    q = rng.standard_normal(4)
    np.testing.assert_allclose(tg.q2r(q), jg.q2r(q), rtol=0, atol=1e-6)
    m = np.eye(4)
    m[:3, :3] = tg.q2r(q)
    m[:3, 3] = rng.uniform(-5, 5, 3)
    np.testing.assert_allclose(tg.m2ypr(m), jg.m2ypr(m), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.m2xyz_ypr(m), jg.m2xyz_ypr(m), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tg.rotz(0.3), jg.rotz(0.3))
    gimbal = np.eye(4)
    gimbal[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    with pytest.raises(ValueError, match="gimbal"):
        tg.m2ypr(gimbal)


def test_rotation_error_matches_jax(rng):
    r_est = np.stack([jg.q2r(rng.standard_normal(4)) for _ in range(16)]).astype(np.float32)
    r_gt = np.stack([jg.q2r(rng.standard_normal(4)) for _ in range(16)]).astype(np.float32)
    r_gt[:3] = r_est[:3]  # zero error (clipped cosine)
    want = np.asarray(jg.rotation_error_deg(jnp.asarray(r_est), jnp.asarray(r_gt)))
    got = tg.rotation_error_deg(*_t(r_est, r_gt)).numpy()
    # the cosines agree to f32 rounding; arccos magnifies an ulp near cos 1
    # (zero error) to hundredths of a degree, so degrees are held elsewhere
    np.testing.assert_allclose(np.cos(np.radians(got)), np.cos(np.radians(want)), atol=1e-6)
    np.testing.assert_allclose(got[3:], want[3:], rtol=0, atol=1e-3)
    assert (got[:3] < 0.05).all() and (want[:3] < 0.05).all()


# ---------------------------------------------------------------------------
# Kabsch, matching, RANSAC
# ---------------------------------------------------------------------------

def test_kabsch_matches_jax(rng):
    """Weighted random sets (some weights zero) and an exact rigid motion."""
    for n in (3, 10, 64):
        p = rng.standard_normal((n, 3)).astype(np.float32) * 10
        t = _pose(rng).astype(np.float32)
        q = (p @ t[:3, :3].T + t[:3, 3] + rng.normal(0, 0.1, (n, 3))).astype(np.float32)
        w = (rng.uniform(0, 1, n) * (rng.random(n) > 0.2)).astype(np.float32)
        w[:3] = 1.0
        want = np.asarray(j_kabsch(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w)))
        got = kabsch(*_t(p, q, w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    exact = p @ t[:3, :3].T + t[:3, 3]
    np.testing.assert_allclose(kabsch(*_t(p, exact.astype(np.float32), np.ones(n, np.float32)))
                               .numpy(), t, atol=1e-4)
    # batched leading dims equal the one-by-one results
    ps = rng.standard_normal((2, 5, 3, 3)).astype(np.float32)
    qs = rng.standard_normal((2, 5, 3, 3)).astype(np.float32)
    ws = np.ones((2, 5, 3), np.float32)
    batched = kabsch(*_t(ps, qs, ws)).numpy()
    for i in range(2):
        for j in range(5):
            np.testing.assert_allclose(batched[i, j], kabsch(*_t(ps[i, j], qs[i, j], ws[i, j]))
                                       .numpy(), rtol=0, atol=1e-6)


def test_mutual_matches_bit_equal(rng):
    d1 = rng.standard_normal((40, 16)).astype(np.float32)
    d2 = rng.standard_normal((50, 16)).astype(np.float32)
    d2[:30] = d1[:30] + rng.normal(0, 0.1, (30, 16))
    m1, m2 = rng.random(40) > 0.2, rng.random(50) > 0.2
    j_idx, j_valid = j_mutual_matches(*map(jnp.asarray, (d1, m1, d2, m2)))
    idx, valid = mutual_matches(*_t(d1, m1, d2, m2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert valid.sum() > 10
    # no valid keypoint in cloud 2: nothing matches
    _, none = mutual_matches(*_t(d1, m1, d2, np.zeros(50, bool)))
    assert not none.any()


def _ransac_inputs(rng, n_pairs, **kw):
    pairs = [make_pair(rng, **kw) for _ in range(n_pairs)]
    kp1, d1, kp2, d2, t = (np.stack(x) for x in zip(*pairs))
    m1 = np.ones(kp1.shape[:2], bool)
    m2 = np.ones(kp2.shape[:2], bool)
    m1[:, -4:] = False  # padding rows with far-away garbage
    kp1[:, -4:] = 1e6
    return kp1, d1, m1, kp2, d2, m2, t


@pytest.mark.parametrize("refine_iters", [0, 2])
def test_ransac_matches_jax_from_jax_draws(rng, refine_iters):
    """The port from JAX's draws: the same best hypothesis (refine_iters 0
    returns it), the same refined transform within 1e-5, equal inlier and
    match counts."""
    n_hyp = 64
    kp1, d1, m1, kp2, d2, m2, _ = _ransac_inputs(rng, 3)
    key = jax.random.PRNGKey(7)
    for j in range(3):
        args = [jnp.asarray(a[j]) for a in (kp1, d1, m1, kp2, d2, m2)]
        want = jax.jit(lambda k, *a: j_ransac(k, *a, n_hypotheses=n_hyp,
                                              refine_iters=refine_iters))(key, *args)
        valid = np.asarray(j_mutual_matches(args[1], args[2], args[4], args[5])[1])
        sel = jax_draws(key, valid, n_hyp)
        got = ransac_6dof(*_t(*(a[j:j + 1] for a in (kp1, d1, m1, kp2, d2, m2))),
                          n_hypotheses=n_hyp, refine_iters=refine_iters,
                          samples=torch.from_numpy(sel[None]))
        np.testing.assert_allclose(got.transform[0].numpy(), np.asarray(want.transform),
                                   rtol=0, atol=1e-5)
        assert int(got.n_inliers[0]) == int(want.n_inliers)
        assert int(got.n_matches[0]) == int(want.n_matches)
        np.testing.assert_allclose(float(got.inlier_rmse[0]), float(want.inlier_rmse),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got.fitness[0]), float(want.fitness), rtol=1e-6)
        assert int(want.n_inliers) > 40


def test_ransac_batched_equals_pair_by_pair(rng):
    kp1, d1, m1, kp2, d2, m2, _ = _ransac_inputs(rng, 4)
    gen = torch.Generator().manual_seed(3)
    _, valid = mutual_matches(*_t(d1, m1, d2, m2))
    samples = draw_samples(valid, 128, gen)
    batched = ransac_6dof(*_t(kp1, d1, m1, kp2, d2, m2), n_hypotheses=128, samples=samples)
    for j in range(4):
        one = ransac_6dof(*_t(*(a[j:j + 1] for a in (kp1, d1, m1, kp2, d2, m2))),
                          n_hypotheses=128, samples=samples[j:j + 1])
        np.testing.assert_allclose(batched.transform[j].numpy(), one.transform[0].numpy(),
                                   rtol=0, atol=1e-6)
        assert int(batched.n_inliers[j]) == int(one.n_inliers[0])
        assert int(batched.n_matches[j]) == int(one.n_matches[0])
    # a generator gives the draws draw_samples gives
    again = ransac_6dof(*_t(kp1, d1, m1, kp2, d2, m2), n_hypotheses=128,
                        gen=torch.Generator().manual_seed(3))
    assert torch.equal(again.transform, batched.transform)
    with pytest.raises(ValueError, match="generator"):
        ransac_6dof(*_t(kp1, d1, m1, kp2, d2, m2))


def test_draw_samples_distinct_and_valid(rng):
    valid = torch.from_numpy(rng.random((5, 40)) > 0.5)
    valid[3] = False
    valid[3, [4, 9]] = True   # 2 valid: every draw must include an invalid one
    valid[4] = False
    valid[4, [1, 2, 30]] = True
    s = draw_samples(valid, 2000, torch.Generator().manual_seed(0))
    assert s.shape == (5, 2000, 3) and s.dtype == torch.int64
    assert bool((s[..., 0] != s[..., 1]).all() & (s[..., 1] != s[..., 2]).all()
                & (s[..., 0] != s[..., 2]).all())
    picked = torch.gather(valid, 1, s.reshape(5, -1)).reshape(5, 2000, 3)
    for i in (0, 1, 2, 4):
        assert bool(picked[i].all())
        # uniform over the valid matches: every one drawn, none far off its share
        counts = torch.bincount(s[i].reshape(-1), minlength=40)[valid[i]].double()
        share = counts / counts.sum()
        assert bool((share - 1 / int(valid[i].sum())).abs().max() < 0.03)
    assert not bool(picked[3].all(-1).any())


def test_ransac_recovers_known_transform(rng):
    """The port's own draws, at evaluation sizes (K 256, 128-d, a quarter
    outliers, any yaw, 10 m): RTE < 0.1 m, RRE < 0.5 deg."""
    kp1, d1, m1, kp2, d2, m2, t = _ransac_inputs(rng, 4, k=256, n_outliers=64, dim=128,
                                                  max_t=10.0)
    res = ransac_6dof(*_t(kp1, d1, m1, kp2, d2, m2), n_hypotheses=256,
                      gen=torch.Generator().manual_seed(0))
    est = res.transform.numpy()
    rte = np.linalg.norm(est[:, :3, 3] - t[:, :3, 3], axis=1)
    rre = tg.rotation_error_deg(res.transform[:, :3, :3], torch.from_numpy(t[:, :3, :3])).numpy()
    assert (rte < 0.1).all(), rte
    assert (rre < 0.5).all(), rre
    assert (res.n_inliers.numpy() > 150).all()


# ---------------------------------------------------------------------------
# retrieval, ICP
# ---------------------------------------------------------------------------

def test_topk_l2_matches_jax(rng):
    m = rng.standard_normal((300, 64)).astype(np.float32)
    q = rng.standard_normal((50, 64)).astype(np.float32)
    want = j_topk_l2(m, q, 10)
    got = topk_l2(m, q, 10, chunk=16, device=CPU)
    np.testing.assert_array_equal(got, want)
    brute = np.argsort(np.linalg.norm(q[:, None].astype(np.float64) - m[None], axis=-1),
                       axis=1)[:, :10]
    np.testing.assert_array_equal(got, brute)
    assert topk_l2(m[:5], q, 10, device=CPU).shape == (50, 5)


def _scene(rng, n):
    """tests/test_icp.py's walls + ground."""
    g = rng.uniform(-20, 20, (n // 2, 2))
    pts = [np.column_stack([g, rng.normal(0, 0.01, n // 2)]),
           np.column_stack([rng.uniform(-20, 20, n // 4), rng.normal(5, 0.01, n // 4),
                            rng.uniform(0, 5, n // 4)]),
           np.column_stack([rng.normal(-8, 0.01, n // 4), rng.uniform(-20, 20, n // 4),
                            rng.uniform(0, 5, n // 4)])]
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("point2plane", [False, True])
def test_icp_matches_jax(point2plane):
    """Both modes from tests/test_icp.py's perturbed start: within 1e-6 of
    JAX's result, and the truth recovered."""
    rng = np.random.default_rng(0)
    pc1 = _scene(rng, 2000)
    t_true = jg.rotz(0.05)
    t_true[:3, 3] = [0.4, -0.3, 0.1]
    pc2 = (pc1 @ t_true[:3, :3].T + t_true[:3, 3]).astype(np.float32)
    d = jg.rotz(0.02)
    d[:3, 3] = [0.15, 0.1, -0.05]
    init = d @ t_true
    got = ti.icp(pc1, pc2, init, point2plane=point2plane)
    np.testing.assert_allclose(got, ji.icp(pc1, pc2, init, point2plane=point2plane),
                               rtol=0, atol=1e-6)
    assert np.linalg.norm(got[:3, 3] - t_true[:3, 3]) < 0.05
    normals = ti.estimate_normals(pc2[:300], k=12)
    np.testing.assert_allclose(np.abs(normals), np.abs(ji.estimate_normals(pc2[:300], k=12)),
                               rtol=0, atol=1e-6)
