"""Port vs JAX: the training losses (egonn_tpu_torch.losses) on the CPU.

Values, every stat and the gradients with respect to the inputs, on seeded
numpy inputs that include anchors without positives or negatives and padded
keypoints and points.  Mining picks indices by argmax / argmin, so each test
first asserts that both sides picked the same ones: a near-tie then shows as
such rather than as a large loss difference.

Tolerances: f32 on both sides, summation order only (tests/conftest.py pins
JAX's matmul precision to highest): values and stats rel 1e-5 (atol 1e-6),
gradients max abs error <= 1e-4 x max |JAX grad|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonn_tpu.losses import keypoint as jkp
from egonn_tpu.losses import triplet as jtr
from egonn_tpu_torch.losses import keypoint as tkp
from egonn_tpu_torch.losses import triplet as ttr

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 1e-4


def _grad_close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale, (what, err, scale)


def _stats_close(t_stats, j_stats):
    assert set(t_stats) == set(j_stats)
    for k in j_stats:
        np.testing.assert_allclose(float(t_stats[k]), float(j_stats[k]), err_msg=k, **VAL_TOL)


def _masks(rng, b):
    """Pairs of places; anchor 0 has no positive, anchor 1 no negative."""
    labels = np.arange(b) // 2
    pos = (labels[:, None] == labels[None, :]) & ~np.eye(b, dtype=bool)
    neg = labels[:, None] != labels[None, :]
    pos[0] = False
    neg[1] = False
    return pos, neg


def test_pairwise_l2_zero_distance_gradient(rng):
    x = rng.standard_normal((5, 4)).astype(np.float32)
    x[3] = x[1]
    xt = torch.from_numpy(x).requires_grad_()
    d = ttr.pairwise_l2(xt, xt)
    d.sum().backward()
    gj = jax.grad(lambda a: jtr.pairwise_l2(a, a).sum())(jnp.asarray(x))
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jtr.pairwise_l2(x, x)), **VAL_TOL)
    _grad_close(xt.grad.numpy(), gj, "pairwise_l2")


@pytest.mark.parametrize("loss", ["triplet", "contrastive"])
def test_global_losses(rng, loss):
    b, d = 10, 16
    emb = rng.standard_normal((b, d)).astype(np.float32)
    pos, neg = _masks(rng, b)
    if loss == "triplet":
        j_fn = functools.partial(jtr.batch_hard_triplet_loss, margin=0.5)
        t_fn = functools.partial(ttr.batch_hard_triplet_loss, margin=0.5)
    else:
        j_fn = functools.partial(jtr.batch_hard_contrastive_loss, pos_margin=0.2, neg_margin=3.0)
        t_fn = functools.partial(ttr.batch_hard_contrastive_loss, pos_margin=0.2, neg_margin=3.0)

    # the mined triplets first
    dist_j = jtr.pairwise_l2(jnp.asarray(emb), jnp.asarray(emb))
    mined_j = jtr.mine_hardest(dist_j, jnp.asarray(pos), jnp.asarray(neg))
    dist_t = ttr.pairwise_l2(torch.from_numpy(emb), torch.from_numpy(emb))
    mined_t = ttr.mine_hardest(dist_t, torch.from_numpy(pos), torch.from_numpy(neg))
    for i, what in enumerate(("valid", "p_idx", "n_idx")):
        np.testing.assert_array_equal(mined_t[i].numpy(), np.asarray(mined_j[i]), err_msg=what)
    assert not mined_t[0][:2].any() and mined_t[0][2:].all()

    (l_j, s_j), g_j = jax.value_and_grad(
        lambda e: j_fn(e, jnp.asarray(pos), jnp.asarray(neg)), has_aux=True)(jnp.asarray(emb))
    et = torch.from_numpy(emb).requires_grad_()
    l_t, s_t = t_fn(et, torch.from_numpy(pos), torch.from_numpy(neg))
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), **VAL_TOL)
    assert float(l_t.detach()) > 0
    _stats_close(s_t, s_j)
    assert all(not v.requires_grad for v in s_t.values())
    _grad_close(et.grad.numpy(), g_j, "d loss / d embeddings")


def _local_inputs(rng, b=2, k1=40, k2=36, n=300):
    """Keypoints of cloud 2 near the transformed keypoints of cloud 1 (so
    some match within 0.5 m), padded keypoints and points."""
    th = rng.uniform(-0.3, 0.3, b)
    t_gt = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    t_gt[:, 0, 0] = t_gt[:, 1, 1] = np.cos(th)
    t_gt[:, 0, 1], t_gt[:, 1, 0] = -np.sin(th), np.sin(th)
    t_gt[:, :3, 3] = rng.normal(0, 1, (b, 3))
    kp1 = rng.uniform(-5, 5, (b, k1, 3)).astype(np.float32)
    moved = kp1 @ np.transpose(t_gt[:, :3, :3], (0, 2, 1)) + t_gt[:, None, :3, 3]
    kp2 = moved[:, :k2] + rng.normal(0, 0.3, (b, k2, 3))
    kp2 = kp2.astype(np.float32)
    kp1_m = np.ones((b, k1), bool)
    kp2_m = np.ones((b, k2), bool)
    kp1_m[0, 30:] = False
    kp2_m[1, 25:] = False
    # padded keypoints sit at the origin, as the model's masked outputs do
    kp1[~kp1_m] = 0
    kp2[~kp2_m] = 0
    sig1 = rng.uniform(0.2, 2, (b, k1, 1)).astype(np.float32)
    sig2 = rng.uniform(0.2, 2, (b, k2, 1)).astype(np.float32)
    d1 = rng.standard_normal((b, k1, 8)).astype(np.float32)
    d2 = rng.standard_normal((b, k2, 8)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    pc1 = rng.uniform(-6, 6, (b, n, 3)).astype(np.float32)
    pc2 = rng.uniform(-6, 6, (b, n, 3)).astype(np.float32)
    pc1_m = np.ones((b, n), bool)
    pc2_m = np.ones((b, n), bool)
    pc1_m[1, 200:] = False
    pc2_m[0, 250:] = False
    pc1[~pc1_m] = 0
    pc2[~pc2_m] = 0
    return dict(clouds1=pc1, clouds1_mask=pc1_m, kp1=kp1, sigma1=sig1, desc1=d1, kp1_mask=kp1_m,
                clouds2=pc2, clouds2_mask=pc2_m, kp2=kp2, sigma2=sig2, desc2=d2, kp2_mask=kp2_m,
                t_gt=t_gt)


DIFF = ("kp1", "sigma1", "desc1", "kp2", "sigma2", "desc2")


@pytest.mark.parametrize("gammas", [(1.0, 1.0, 1.0, 4.0), (2.0, 0.5, 3.0, 1.0)])
def test_keypoint_corr_loss(rng, gammas):
    inp = _local_inputs(rng)
    kw = dict(gamma_chamfer=gammas[0], gamma_p2p=gammas[1], gamma_c=gammas[2], beta=gammas[3])

    # the matches both sides mine: keypoint-to-keypoint both ways, and each
    # keypoint's nearest point of its own cloud
    kp1t = np.asarray(jax.vmap(lambda k, m: jnp.asarray(k) @ m[:3, :3].T + m[:3, 3])(
        inp["kp1"], inp["t_gt"]))
    d12 = np.asarray(jax.vmap(jtr.pairwise_l2)(kp1t, inp["kp2"]))
    d12 = np.where(inp["kp1_mask"][:, :, None] & inp["kp2_mask"][:, None, :], d12, jkp.BIG)
    d12_t = ttr.pairwise_l2(tkp.apply_transform(torch.from_numpy(inp["kp1"]),
                                                torch.from_numpy(inp["t_gt"])),
                            torch.from_numpy(inp["kp2"]))
    d12_t = torch.where(torch.from_numpy(inp["kp1_mask"][:, :, None] & inp["kp2_mask"][:, None]),
                        d12_t, tkp.BIG)
    np.testing.assert_array_equal(d12_t.argmin(-1).numpy(), d12.argmin(-1))
    np.testing.assert_array_equal(d12_t.argmin(-2).numpy(), d12.argmin(-2))
    for i in ("1", "2"):
        dj = np.asarray(jax.vmap(jtr.pairwise_l2)(inp["kp" + i], inp["clouds" + i]))
        dj = np.where(inp[f"clouds{i}_mask"][:, None, :], dj, jkp.BIG)
        d_t = tkp._nearest_point_dist(torch.from_numpy(inp["kp" + i]),
                                      torch.from_numpy(inp["clouds" + i]),
                                      torch.from_numpy(inp[f"clouds{i}_mask"]))
        # |x|^2 + |y|^2 - 2 x.y cancels: at ~5 m, |x|^2 ~ 75 m^2 rounds by
        # ~5e-6 m^2 in f32, ~1e-5 m on a 0.3 m distance
        np.testing.assert_allclose(d_t.numpy(), dj.min(-1), rtol=0, atol=5e-5)

    names = list(inp)

    def j_loss(*diff):
        args = {**{k: jnp.asarray(v) for k, v in inp.items()}, **dict(zip(DIFF, diff))}
        return jkp.keypoint_corr_loss(*(args[k] for k in names), **kw)

    (l_j, s_j), g_j = jax.value_and_grad(j_loss, argnums=tuple(range(len(DIFF))),
                                         has_aux=True)(*(jnp.asarray(inp[k]) for k in DIFF))
    t_in = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in DIFF:
        t_in[k].requires_grad_()
    l_t, s_t = tkp.keypoint_corr_loss(*(t_in[k] for k in names), **kw)
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), **VAL_TOL)
    _stats_close(s_t, s_j)
    assert 0 < float(s_t["matching_keypoints"]) < 30
    for k, gj in zip(DIFF, g_j):
        _grad_close(t_in[k].grad.numpy(), gj, f"d loss / d {k}")


def test_neg_similarity_scatter_order(rng):
    """Column 0 is cleared again by an unselected row after a selected row
    with target 0, as the JAX package's in-order scatter leaves it."""
    k1, k2 = 6, 5
    sim = rng.standard_normal((k1, k2)).astype(np.float32)
    kp2_mask = np.ones(k2, bool)
    logits = np.where(kp2_mask[None], sim, -jkp.BIG)
    for target, row_sel in [([0, 3, 0, 2, 1, 0], [True, True, False, True, False, False]),
                            ([0, 3, 0, 2, 1, 0], [False, True, True, True, False, True]),
                            ([4, 4, 1, 2, 0, 0], [True, True, True, True, True, True])]:
        target, row_sel = np.array(target), np.array(row_sel)
        want = jkp._neg_similarity(jnp.asarray(logits), jnp.asarray(sim), jnp.asarray(target),
                                   jnp.asarray(row_sel), jnp.asarray(kp2_mask))
        got = tkp._neg_similarity(torch.from_numpy(logits[None]), torch.from_numpy(sim[None]),
                                  torch.from_numpy(target[None]), torch.from_numpy(row_sel[None]),
                                  torch.from_numpy(kp2_mask[None]))
        np.testing.assert_allclose(float(got[0]), float(want), **VAL_TOL)


def test_make_losses_reads_params():
    class P:
        loss, margin, loss_gammas = "BatchHardTripletMarginLoss", 0.3, [1.0, 2.0, 3.0, 4.0]

    gl, loc = tkp.make_losses(P)
    assert gl.func is ttr.batch_hard_triplet_loss and gl.keywords == {"margin": 0.3}
    assert loc.keywords == dict(gamma_c=3.0, gamma_chamfer=1.0, gamma_p2p=2.0, beta=4.0)
    P.loss, P.pos_margin, P.neg_margin, P.loss_gammas = "BatchHardContrastiveLoss", 0.1, 0.7, None
    gl, loc = tkp.make_losses(P)
    assert gl.keywords == {"pos_margin": 0.1, "neg_margin": 0.7} and loc.keywords["beta"] == 2.0
    P.loss = "Other"
    with pytest.raises(NotImplementedError):
        tkp.make_losses(P)


def test_nearest_point_dist_in_blocks(rng, monkeypatch):
    """Blocks of points give the nearest point (and its gradient) of the
    whole cloud: equal to one block over all points."""
    inp = _local_inputs(rng)
    args = [torch.from_numpy(inp[k]) for k in ("kp1", "clouds1", "clouds1_mask")]
    args[0].requires_grad_()
    whole = tkp._nearest_point_dist(*args)
    whole.sum().backward()
    g_whole = args[0].grad.clone()
    args[0].grad = None
    monkeypatch.setattr(tkp, "_CLOUD_CHUNK", 64)
    blocks = tkp._nearest_point_dist(*args)
    blocks.sum().backward()
    assert torch.equal(blocks, whole) and torch.equal(args[0].grad, g_whole)
    empty = tkp._nearest_point_dist(args[0], args[1], torch.zeros_like(args[2]))
    assert bool((empty == tkp.BIG).all())


def test_gather_rows_backward(rng):
    """The chamfer's sigma gather: forward equal to torch.gather, gradient
    (its one-hot matmul, no atomics) within f32 rounding of torch.gather's
    scatter_add and equal across repeats; rows share targets, as the
    nearest keypoints do."""
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(rng.integers(0, 12, (3, 70)))  # duplicates in every row
    g = torch.from_numpy(rng.standard_normal((3, 70)).astype(np.float32))
    grads = []
    for _ in range(2):
        y = tkp._GatherRows.apply(x, idx)
        assert torch.equal(y, torch.gather(x, 1, idx))
        (gx,) = torch.autograd.grad(y, x, g)
        grads.append(gx)
    (want,) = torch.autograd.grad(torch.gather(x, 1, idx), x, g)
    assert torch.equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0].numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert not grads[0][:, 12:].any()
