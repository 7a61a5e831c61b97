"""Port vs JAX: key packing, dedup and quantization (egonn_tpu_torch.sparse.packing,
egonn_tpu_torch.ops).  Integer outputs must be bit-equal; float outputs of
the geometry helpers agree at f32 tolerance (cos/sin/atan2 may differ by an
ulp between XLA and torch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonn_tpu.data.lidar_sim import lidar_scan_clouds
from egonn_tpu.ops import geometry as jgeo
from egonn_tpu.ops.quantization import CartesianQuantizer as JCartesian
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse import packing as jpk
from egonn_tpu_torch.ops import geometry as tgeo
from egonn_tpu_torch.ops.quantization import CartesianQuantizer, PolarQuantizer
from egonn_tpu_torch.sparse import packing as tpk

STEPS = [1.0, 0.3, 0.2]


def _eq(a_jax, b_torch, what):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("spec", [tpk.DEFAULT_PACK, tpk.halved_spec(tpk.DEFAULT_PACK)])
def test_pack_unpack_halve_bit_equal(rng, spec):
    coords = rng.integers(-1100, 1100, size=(3, 5000)).astype(np.int32)
    mask = rng.random(5000) < 0.9
    jspec = jpk.PackSpec(spec.bits, spec.offsets)
    jk = jpk.pack_keys(jnp.asarray(coords), jnp.asarray(mask), jspec)
    tk = tpk.pack_keys(torch.from_numpy(coords), torch.from_numpy(mask), spec)
    _eq(jk, tk, "pack_keys")
    assert (tk.numpy() != tpk.MAXKEY).sum() > 500  # in-range keys exercised
    _eq(jpk.unpack_keys(jk, jspec), tpk.unpack_keys(tk, spec), "unpack_keys")
    _eq(jpk.halve_keys(jk, jspec), tpk.halve_keys(tk, spec), "halve_keys")
    assert tpk.halved_spec(spec).offsets == jpk.halved_spec(jspec).offsets


@pytest.mark.parametrize("need_index", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_sorted_unique_bit_equal(seed, need_index):
    """Every SortedUnique field, on LiDAR clouds with a ragged mask, at a
    capacity below the unique count (so the overflow path runs too)."""
    clouds = lidar_scan_clouds(2, 4096, seed=seed)
    mask = np.ones((2, 4096), bool)
    mask[1, 3000:] = False
    jq = JPolar(STEPS)
    coords = np.array(jax.vmap(jq.to_polar_voxels)(jnp.asarray(clouds)))
    for capacity in (2048, 4096):
        ju = jax.vmap(lambda c, m: jpk.sorted_unique(c, m, capacity,
                                                     need_index=need_index))(
            jnp.asarray(coords), jnp.asarray(mask))
        tu = tpk.sorted_unique(torch.from_numpy(coords), torch.from_numpy(mask),
                               capacity, need_index=need_index)
        for field in tpk.SortedUnique._fields:
            _eq(getattr(ju, field), getattr(tu, field), f"{field} cap={capacity}")
    assert int(tu.n_unique.max()) > 2048


@pytest.mark.parametrize("seed", [0, 3])
def test_polar_quantize_bit_equal(seed):
    clouds = lidar_scan_clouds(2, 4096, seed=seed)
    mask = np.ones((2, 4096), bool)
    jq, tq = JPolar(STEPS), PolarQuantizer(STEPS)
    jv = jax.vmap(jq.to_polar_voxels)(jnp.asarray(clouds))
    tv = tq.to_polar_voxels(torch.from_numpy(clouds))
    _eq(jv, tv, "to_polar_voxels")
    ju = jax.vmap(lambda p, m: jq.quantize(p, m, 4096, need_index=False))(
        jnp.asarray(clouds), jnp.asarray(mask))
    tu = tq.quantize(torch.from_numpy(clouds), torch.from_numpy(mask), 4096,
                     need_index=False)
    for field in tpk.SortedUnique._fields:
        _eq(getattr(ju, field), getattr(tu, field), field)


def test_cartesian_quantize_bit_equal():
    clouds = lidar_scan_clouds(2, 4096, seed=2)
    mask = np.ones((2, 4096), bool)
    jq, tq = JCartesian(0.5), CartesianQuantizer(0.5)
    ju = jax.vmap(lambda p, m: jq.quantize(p, m, 4096))(jnp.asarray(clouds),
                                                        jnp.asarray(mask))
    tu = tq.quantize(torch.from_numpy(clouds), torch.from_numpy(mask), 4096)
    for field in tpk.SortedUnique._fields:
        _eq(getattr(ju, field), getattr(tu, field), field)


def test_keypoint_position_and_polar_to_cartesian(rng):
    """f32 tolerance: the trig functions of XLA and torch may differ by an ulp;
    at 80 m ranges an ulp of the angle moves a point by ~1e-5 m."""
    coords = rng.integers(0, 400, size=(2, 300, 3)).astype(np.int32) * 8
    offset = rng.uniform(-1, 1, size=(2, 300, 3)).astype(np.float32)
    stride = np.full((3,), 8.0, np.float32)
    jq, tq = JPolar(STEPS), PolarQuantizer(STEPS)
    want = np.asarray(jq.keypoint_position(jnp.asarray(coords), jnp.asarray(stride),
                                           jnp.asarray(offset)))
    got = tq.keypoint_position(torch.from_numpy(coords), torch.from_numpy(stride),
                               torch.from_numpy(offset)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    polar = np.stack([rng.uniform(0, 360, 500), rng.uniform(2, 80, 500),
                      rng.uniform(-2, 10, 500)], -1).astype(np.float32)
    np.testing.assert_allclose(tgeo.polar_to_cartesian(torch.from_numpy(polar)).numpy(),
                               np.asarray(jgeo.polar_to_cartesian(jnp.asarray(polar))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tq.dequantize(torch.from_numpy(coords)).numpy(),
        np.asarray(jq.dequantize(jnp.asarray(coords))), rtol=1e-5, atol=1e-4)
    cart = tgeo.polar_to_cartesian(torch.from_numpy(polar))
    np.testing.assert_allclose(tgeo.cartesian_to_polar(cart).numpy(),
                               np.asarray(jgeo.cartesian_to_polar(jnp.asarray(cart.numpy()))),
                               rtol=1e-5, atol=1e-4)
