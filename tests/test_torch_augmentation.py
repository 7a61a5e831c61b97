"""Port vs JAX: the training augmentations (egonn_tpu_torch.data.augmentation).

JAX's PRNG cannot be reproduced in torch, so each test re-derives the numbers
JAX draws from a key, following the key splits of
`egonn_tpu/data/augmentation.py:96-123`, and hands them to the port's apply
functions; the outputs must then match JAX's.  Tolerance: rtol 1e-6, atol
1e-5 m on coordinates of up to ~80 m (the rotation is an f32 matmul on
both sides; everything else is elementwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.data import augmentation as jaug
from egonn_tpu_torch.data import augmentation as taug
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.data.pipeline import device_preprocess_global, pad_cloud
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse.pyramid import egonn_pyramid_spec

TOL = dict(rtol=1e-6, atol=1e-5)
B, N = 6, 700


def _clouds_and_mask():
    pc = lidar_scan_clouds(B, N, seed=4)
    mask = np.ones((B, N), bool)
    mask[2, 500:] = False
    return pc, mask


def _jax_train_draws(key, n, aug_mode):
    """The numbers train_transform(key, ...) draws, split as it splits."""
    ks = jax.random.split(key, 5)
    k1, k2 = jax.random.split(ks[1])
    kb = jax.random.split(ks[4], 5)
    u = jax.random.uniform
    draws = {
        "noise": jax.random.normal(ks[0], (n, 3)),
        "remove_r": u(k1, (), minval=0.0, maxval=0.1),
        "remove_u": u(k2, (n,)),
        "translation": jax.random.normal(ks[2], (1, 3)),
        "block_area": u(kb[0], (), minval=0.02, maxval=0.33),
        "block_aspect": u(kb[1], (), minval=0.3, maxval=3.3),
        "block_ux": u(kb[2], ()),
        "block_uy": u(kb[3], ()),
        "block_apply": u(kb[4], ()),
    }
    if aug_mode == 2:
        draws["rotation_u"] = u(ks[3], ())
    return draws


def _batched_draws(keys, n, aug_mode):
    per = [_jax_train_draws(k, n, aug_mode) for k in keys]
    return {name: torch.from_numpy(np.stack([np.asarray(d[name]) for d in per]))
            for name in per[0]}


def _keys(seed, b=B):
    return jax.random.split(jax.random.PRNGKey(seed), b)


def test_single_transforms():
    pc, mask = _clouds_and_mask()
    keys = _keys(1)
    d = _batched_draws(keys, N, 2)
    pct, mt = torch.from_numpy(pc), torch.from_numpy(mask)
    ks = [jax.random.split(k, 5) for k in keys]

    want = np.stack([jaug.jitter_points(k[0], p) for k, p in zip(ks, pc)])
    np.testing.assert_allclose(taug.jitter_points(pct, d["noise"]).numpy(), want, **TOL)
    want = np.stack([jaug.remove_random_points(k[1], p) for k, p in zip(ks, pc)])
    got = taug.remove_random_points(pct, d["remove_r"], d["remove_u"]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all(-1).sum() > 0
    want = np.stack([jaug.random_translation(k[2], p) for k, p in zip(ks, pc)])
    np.testing.assert_allclose(taug.random_translation(pct, d["translation"]).numpy(), want, **TOL)
    for max_deg in (180.0, 5.0):
        want = np.stack([jaug.random_rotation_z(k[3], p, max_deg) for k, p in zip(ks, pc)])
        got = taug.random_rotation_z(pct, d["rotation_u"], max_deg).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    want = np.stack([jaug.remove_random_block(k[4], p, m) for k, p, m in zip(ks, pc, mask)])
    got = taug.remove_random_block(pct, mt, d["block_area"], d["block_aspect"], d["block_ux"],
                                   d["block_uy"], d["block_apply"]).numpy()
    np.testing.assert_array_equal(got, want)


def test_remove_random_block_applied():
    """With the apply draw below p the block's points are zeroed, and they
    are JAX's: the JAX function with p = 1 applies the same block."""
    pc, mask = _clouds_and_mask()
    keys = _keys(2)
    d = _batched_draws(keys, N, 1)
    want = np.stack([jaug.remove_random_block(jax.random.split(k, 5)[4], p, m, p=1.0)
                     for k, p, m in zip(keys, pc, mask)])
    got = taug.remove_random_block(torch.from_numpy(pc), torch.from_numpy(mask),
                                   d["block_area"], d["block_aspect"], d["block_ux"],
                                   d["block_uy"], d["block_apply"], p=1.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all(-1).sum() > 0


@pytest.mark.parametrize("aug_mode", [1, 2])
def test_train_transform(aug_mode):
    pc, mask = _clouds_and_mask()
    keys = _keys(10 + aug_mode)
    want = jax.vmap(lambda k, p, m: jaug.train_transform(k, p, m, aug_mode))(
        keys, jnp.asarray(pc), jnp.asarray(mask))
    got = taug.train_transform(torch.from_numpy(pc), torch.from_numpy(mask),
                               _batched_draws(keys, N, aug_mode), aug_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("aug_mode", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_set_transform(aug_mode, seed):
    """Several keys, so the flip draw lands in each of its branches."""
    pc, _ = _clouds_and_mask()
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    draws = {"flip_u": torch.from_numpy(np.asarray(jax.random.uniform(k2, ())))}
    if aug_mode == 1:
        draws["rotation_u"] = torch.from_numpy(np.asarray(jax.random.uniform(k1, ())))
    want = jaug.train_set_transform(key, jnp.asarray(pc), aug_mode)
    got = taug.train_set_transform(torch.from_numpy(pc), draws, aug_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_draws_and_preprocess():
    """The draws' shapes and ranges, the generator's determinism, and an
    augmented preprocess that differs from the plain one."""
    gen = torch.Generator().manual_seed(0)
    d = taug.draw_train_transform(gen, 3, 50, aug_mode=2)
    assert d["noise"].shape == (3, 50, 3) and d["translation"].shape == (3, 1, 3)
    assert bool(((d["remove_r"] >= 0) & (d["remove_r"] < 0.1)).all())
    assert bool(((d["block_aspect"] >= 0.3) & (d["block_aspect"] < 3.3)).all())
    assert "rotation_u" not in taug.draw_train_transform(gen, 3, 50, aug_mode=1)
    with pytest.raises(NotImplementedError):
        taug.train_transform(torch.zeros(1, 4, 3), torch.ones(1, 4, dtype=torch.bool), d, 3)

    pc, mask = _clouds_and_mask()
    pct, mt = torch.from_numpy(pc), torch.from_numpy(mask)
    spec = egonn_pyramid_spec(cap0=512, num_levels=2)
    q = PolarQuantizer([1.0, 0.3, 0.2])
    runs = [device_preprocess_global(pct, mt, q, spec, gen=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    plain = device_preprocess_global(pct, mt, q, spec, with_kmap_down=True)
    assert torch.equal(runs[0][1].kmap_self, runs[1][1].kmap_self)
    assert not torch.equal(runs[0][0].coords, runs[2][0].coords)
    assert not torch.equal(runs[0][0].coords, plain[0].coords)
    assert runs[0][1].kmap_down is None and plain[1].kmap_down is not None


def test_pad_cloud():
    from egonn_tpu.data.pipeline import pad_cloud as j_pad

    rng = np.random.default_rng(0)
    for m in (10, 64, 100):
        pc = rng.standard_normal((m, 3)).astype(np.float32)
        for got, want in zip(pad_cloud(pc, 64), j_pad(pc, 64)):
            np.testing.assert_array_equal(got, want)
