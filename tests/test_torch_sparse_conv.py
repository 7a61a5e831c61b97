"""Port vs JAX: sparse conv ops (egonn_tpu_torch.sparse.conv) on real pyramid
maps.  On the CPU the port's kernels run their plain versions; JAX on the CPU
takes its exact gather engine (sparse/conv.py's non-TPU branches).

Tolerance rtol = atol = 1e-5: both sides compute in f32 (tests/conftest.py
pins JAX's matmul precision to highest), and only the summation order
differs — at most 27 offsets x 128 channels of O(1) terms."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonn_tpu.sparse import banded as jbanded
from egonn_tpu.sparse import conv as jconv
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse import conv as tconv
from egonn_tpu_torch.sparse import pyramid as tpyr

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pyr():
    clouds = torch.from_numpy(lidar_scan_clouds(2, 4096, seed=5))
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    spec = tpyr.egonn_pyramid_spec(cap0=1024, num_levels=3)
    res = PolarQuantizer([1.0, 0.3, 0.2]).quantize(clouds, mask, spec.capacities[0],
                                                   need_index=False)
    return tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)


def _feats(rng, mask, f):
    x = rng.standard_normal((*mask.shape, f)).astype(np.float32)
    return x * mask.numpy()[..., None]


def _epi(rng, f, mask, relu):
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bias = rng.normal(0, 0.3, f).astype(np.float32)
    m = mask.numpy()
    return ((torch.from_numpy(scale), torch.from_numpy(bias), relu, mask),
            (jnp.asarray(scale), jnp.asarray(bias), relu, jnp.asarray(m)))


@pytest.mark.parametrize("level,f_in,f_out", [(1, 16, 16), (2, 24, 32), (3, 128, 128)])
@pytest.mark.parametrize("epi", [None, "relu", "affine"])
def test_sparse_conv(pyr, rng, level, f_in, f_out, epi):
    lvl = pyr[level]
    feats = _feats(rng, lvl.mask, f_in)
    kernel = (rng.standard_normal((27, f_in, f_out)) / np.sqrt(27 * f_in)).astype(np.float32)
    t_epi = j_epi = None
    if epi is not None:
        t_epi, j_epi = _epi(rng, f_out, lvl.mask, epi == "relu")
    got = tconv.sparse_conv(torch.from_numpy(feats), lvl.kmap_self,
                            torch.from_numpy(kernel), epi=t_epi)
    want = jconv.sparse_conv(jnp.asarray(feats), jnp.asarray(lvl.kmap_self.numpy()),
                             jnp.asarray(kernel), epi=j_epi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


@pytest.mark.parametrize("level,f_in,f_out", [(0, 16, 16), (1, 24, 32), (2, 128, 128)])
@pytest.mark.parametrize("with_epi", [False, True])
def test_sparse_tdown(pyr, rng, level, f_in, f_out, with_epi):
    fine, coarse = pyr[level], pyr[level + 1]
    feats = _feats(rng, fine.mask, f_in)
    kernel = (rng.standard_normal((8, f_in, f_out)) / np.sqrt(8 * f_in)).astype(np.float32)
    t_epi = j_epi = None
    if with_epi:
        t_epi, j_epi = _epi(rng, f_out, coarse.mask, True)
    got = tconv.sparse_tdown(torch.from_numpy(feats), fine.up_parent, fine.up_koffset,
                             torch.from_numpy(kernel), coarse.capacity, epi=t_epi)
    j_args = (jnp.asarray(feats), jnp.asarray(fine.up_parent.numpy()),
              jnp.asarray(fine.up_koffset.numpy()), jnp.asarray(kernel))
    if with_epi:
        want = jconv.sparse_tdown(*j_args, coarse.capacity,
                                  jnp.asarray(coarse.mask.numpy()), epi=j_epi)
    else:
        want = jbanded.plain_tdown(*j_args, coarse.capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


@pytest.mark.parametrize("level,f_in,f_out", [(0, 16, 16), (2, 128, 128)])
def test_sparse_tconv2x2(pyr, rng, level, f_in, f_out):
    fine, coarse = pyr[level], pyr[level + 1]
    feats = _feats(rng, coarse.mask, f_in)
    kernel = rng.standard_normal((8, f_in, f_out)).astype(np.float32)
    got = tconv.sparse_tconv2x2(torch.from_numpy(feats), fine.up_parent, fine.up_koffset,
                                torch.from_numpy(kernel))
    want = jconv.sparse_tconv2x2(jnp.asarray(feats), jnp.asarray(fine.up_parent.numpy()),
                                 jnp.asarray(fine.up_koffset.numpy()), jnp.asarray(kernel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_conv_ones_and_1x1(pyr, rng):
    lvl0 = pyr[0]
    kernel = rng.standard_normal((125, 1, 32)).astype(np.float32)
    got = tconv.sparse_conv_ones(lvl0.kmap_self, torch.from_numpy(kernel), lvl0.capacity)
    want = jconv.sparse_conv_ones(jnp.asarray(lvl0.kmap_self.numpy()), jnp.asarray(kernel),
                                  lvl0.capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    feats = _feats(rng, pyr[3].mask, 128)
    k1 = rng.standard_normal((128, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tconv.sparse_conv1x1(torch.from_numpy(feats), torch.from_numpy(k1)).numpy(),
        np.asarray(jconv.sparse_conv1x1(jnp.asarray(feats), jnp.asarray(k1))), **TOL)
