"""Port vs JAX: the coordinate pyramid (egonn_tpu_torch.sparse.pyramid) and the
plain versions of the z-run kernels (egonn_tpu_torch.sparse.kernels).

JAX runs on the CPU here, where build_pyramid takes its exact lookup engine
for every kernel map; the port builds its self maps from the z-run bits and
ranks.  Every integer array is bit-equal, except the level-0 stem map: the
z-run path stores 0 / sentinel there (presence only, for the constant-ones
stem) and the lookup path stores positions, so only validity is compared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse import banded as jbanded
from egonn_tpu.sparse import pyramid as jpyr
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.packing import MAXKEY

STEPS = [1.0, 0.3, 0.2]


def _clouds(seed, b=2, n=4096):
    """The cloud shape of tests/test_banded.py::_real_pyramid."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = np.abs(rng.normal(25, 18, (b, n))).clip(2, 80)
    z = rng.uniform(-1, 10, (b, n))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)


def _both_pyramids(seed, cap0=1024, num_levels=3, canonical=True):
    """canonical: level 0 from a quantizer (keys0 given, as the model path
    does); otherwise build_pyramid dedups the raw voxel coords itself."""
    clouds = _clouds(seed)
    mask = np.ones(clouds.shape[:2], bool)
    mask[1, 3500:] = False
    jspec = jpyr.egonn_pyramid_spec(cap0=cap0, num_levels=num_levels)
    tspec = tpyr.egonn_pyramid_spec(cap0=cap0, num_levels=num_levels)
    assert tspec.capacities == jspec.capacities
    jq = JPolar(STEPS)
    if not canonical:
        raw = jax.vmap(jq.to_polar_voxels)(jnp.asarray(clouds))
        jp = jax.jit(lambda c, m: jpyr.build_pyramid(c, m, jspec))(raw, jnp.asarray(mask))
        tp = tpyr.build_pyramid(torch.from_numpy(np.array(raw)), torch.from_numpy(mask), tspec)
        return jp, tp, jspec, tspec
    res = jax.vmap(lambda p, m: jq.quantize(p, m, jspec.capacities[0],
                                            need_index=False))(jnp.asarray(clouds),
                                                               jnp.asarray(mask))
    jp = jax.jit(lambda c, m, k: jpyr.build_pyramid(c, m, jspec, keys0=k))(
        res.coords_t, res.mask, res.keys)
    coords, m0, keys = (torch.from_numpy(np.array(a)) for a in
                        (res.coords_t, res.mask, res.keys))
    tp = tpyr.build_pyramid(coords, m0, tspec, keys0=keys)
    return jp, tp, jspec, tspec


def _eq(a_jax, b_torch, what):
    a, b = np.asarray(a_jax), b_torch.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("seed,canonical", [(0, True), (1, True), (2, False)])
def test_pyramid_bit_equal(seed, canonical):
    jp, tp, jspec, tspec = _both_pyramids(seed, canonical=canonical)
    for l in range(tspec.num_levels + 1):
        jl, tl = jp[l], tp[l]
        for field in ("coords", "mask", "n_unique", "up_parent", "up_koffset",
                      "source_index"):
            a, b = getattr(jl, field), getattr(tl, field)
            assert (a is None) == (b is None), (l, field)
            if a is not None:
                _eq(a, b, f"L{l} {field}")
        c = tspec.capacities[l]
        if l == 0:
            _eq(np.asarray(jl.kmap_self) < c, tl.kmap_self < c, "L0 kmap validity")
        else:
            _eq(jl.kmap_self, tl.kmap_self, f"L{l} kmap_self")
        # the maps are not trivially empty
        assert int((tl.kmap_self < c).sum()) > int(tl.mask.sum())
    assert tspec.num_levels == 3
    report = tpyr.capacity_report(tp, tspec)
    assert report == jpyr.capacity_report(jp, jspec)


def test_kernel_offsets_and_spec():
    for k in (2, 3, 5):
        np.testing.assert_array_equal(tpyr.kernel_offsets(k), jpyr.kernel_offsets(k))
        np.testing.assert_array_equal(tpyr._xy_offsets(k), jpyr._xy_offsets(k))
    for cap0 in (512, 16384):
        j, t = jpyr.egonn_pyramid_spec(cap0=cap0), tpyr.egonn_pyramid_spec(cap0=cap0)
        assert (t.capacities, t.self_levels, t.up_levels, t.conv0_ones) == \
            (j.capacities, j.self_levels, j.up_levels, j.conv0_ones)
        for l in range(t.num_levels + 1):
            assert t.pack_at(l).offsets == j.pack_at(l).offsets


@pytest.mark.parametrize("level,kz", [(0, 5), (1, 3), (2, 3)])
def test_zrun_plain_matches_pallas_interpret(level, kz):
    """The port's plain zrun_presence / zrun_rank against the Pallas kernels in
    interpret mode, on real pyramid queries where the bands fit (JAX's ok):
    bits bit-equal everywhere, rank bit-equal where the query is valid (the
    rank of a MAXKEY query is unused; the port defines it as 0)."""
    jp, tp, jspec, tspec = _both_pyramids(0)
    lvl = tp[level]
    xy = tpyr._xy_offsets(kz)
    pack = tspec.pack_at(level)
    q_lo, jshift, top = tpyr._zrun_queries(lvl.coords, lvl.mask, kz, pack)
    keys = torch.from_numpy(np.array(
        jax.vmap(lambda c, m: jpyr.pack_keys(c, m, jspec.pack_at(level)))(
            jp[level].coords, jp[level].mask)))
    jq = jax.vmap(lambda c, m: jpyr._zrun_queries(c, m, xy, kz, -(kz // 2), jspec.pack_at(level)))(
        jp[level].coords, jp[level].mask)
    for a, b, what in zip(jq, (q_lo, jshift, top), ("q_lo", "jshift", "top_mask")):
        _eq(a, b, what)
    # the level's sorted table: its packed keys, ascending with MAXKEY pads
    assert bool((keys[:, 1:] >= keys[:, :-1]).all())
    valid = q_lo.numpy() != MAXKEY
    assert valid.sum() > 0

    bits_p = kernels.zrun_presence(keys, q_lo, kz)
    jbits_p, ok_p = jbanded.zrun_presence(jnp.asarray(keys.numpy()), jnp.asarray(q_lo.numpy()),
                                          kz=kz, interpret=True)
    assert bool(ok_p)
    _eq(jbits_p, bits_p, "zrun_presence bits")
    assert int((bits_p != 0).sum()) > 0

    bits, rank = kernels.zrun_rank(keys, q_lo, kz)
    jbits, jrank, ok = jbanded.zrun_rank(jnp.asarray(keys.numpy()), jnp.asarray(q_lo.numpy()),
                                         kz=kz, interpret=True)
    assert bool(ok)
    _eq(jbits, bits, "zrun_rank bits")
    np.testing.assert_array_equal(np.asarray(jrank)[valid], rank.numpy()[valid])
    assert not rank.numpy()[~valid].any()
