"""Port vs JAX: the sorted-key lookup (`packing.lookup_sorted`,
`kernels.lookup` / `lookup_plain`), the kernel-map queries and the
lookup-built `kmap_down` of `build_pyramid`.

JAX runs on the CPU, where its pyramid builds every down map of a level
without an up map with `lookup_sorted`: the ground truth.  Integers are
compared bit-equal.  The Pallas lookup kernel runs in interpret mode on the
queries of tests/test_banded.py::test_banded_lookup_matches_reference, and
`zrun_rank` with kz = 1 (presence bit + rank) is a second oracle.  The CUDA
kernel is held against its plain version in tests/test_torch_kernels.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse import banded as jbanded
from egonn_tpu.sparse import packing as jpacking
from egonn_tpu.sparse import pyramid as jpyr
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import packing as tpacking
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.packing import MAXKEY

STEPS = [1.0, 0.3, 0.2]


def _tables(gen, b, c_in, n_valid, spread):
    keys = np.full((b, c_in), MAXKEY, np.int32)
    for i in range(b):
        keys[i, :n_valid[i]] = np.sort(gen.choice(spread, n_valid[i], replace=False))
    return keys


def _queries(gen, keys, shape, spread):
    """Half present keys, the rest random; 10% MAXKEY; a few below and above
    every key."""
    b = keys.shape[0]
    q = gen.integers(-5, spread + 5, size=shape)
    pick = keys[np.arange(b)[:, None, None], gen.integers(0, keys.shape[1], size=shape)]
    q = np.where(gen.random(shape) < 0.5, pick, q)
    return np.where(gen.random(shape) < 0.1, MAXKEY, q).astype(np.int32)


def _j_lookup(keys, queries):
    c = keys.shape[1]
    return np.asarray(jax.vmap(lambda sk, q: jpacking.lookup_sorted(sk, q, sentinel=c))(
        jnp.asarray(keys), jnp.asarray(queries)))


@pytest.mark.parametrize("c_in,n_valid", [(64, (40, 0)), (1000, (1000, 517)),
                                          (4096, (3000, 4095))])
def test_lookup_matches_jax(c_in, n_valid):
    """Full, empty and partly filled tables, with JAX's chunked path (more
    than 2^14 queries) in the largest case."""
    gen = np.random.default_rng(c_in)
    keys = _tables(gen, 2, c_in, n_valid, 5 * c_in)
    queries = _queries(gen, keys, (2, 8, c_in), 5 * c_in)
    want = _j_lookup(keys, queries)
    keys_t, q_t = torch.from_numpy(keys), torch.from_numpy(queries)
    got = kernels.lookup(keys_t, q_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kernels.lookup_plain(keys_t, q_t).numpy(), want)
    # per cloud, with the JAX signature (a 1-D table, any query shape)
    for i in range(2):
        one = tpacking.lookup_sorted(keys_t[i], q_t[i], sentinel=c_in)
        np.testing.assert_array_equal(one.numpy(), want[i])
    assert (want < c_in).sum() > 0 and (want == c_in).sum() > 0


def _real_level1_keys():
    """Level-1 keys of tests/test_banded.py::_real_pyramid (rng seed 0)."""
    rng = np.random.default_rng(0)
    b, n = 2, 4096
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = np.abs(rng.normal(25, 18, (b, n))).clip(2, 80)
    z = rng.uniform(-1, 10, (b, n))
    clouds = jnp.asarray(np.stack([r * np.cos(theta), r * np.sin(theta), z], -1)
                         .astype(np.float32))
    mask = jnp.ones((b, n), bool)
    q = JPolar(STEPS)
    spec = jpyr.egonn_pyramid_spec(cap0=1024, num_levels=3, min_out_level=1)

    @jax.jit
    def level1_keys(c, m):
        res = jax.vmap(lambda pc, mm: q.quantize(pc, mm, spec.capacities[0],
                                                 need_index=False))(c, m)
        pyr = jpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
        keys = jax.vmap(lambda c, m: jpacking.pack_keys(c, m, spec.pack_at(1)))(
            pyr[1].coords, pyr[1].mask)
        return jnp.sort(keys, axis=1)

    return np.array(level1_keys(clouds, mask))


def test_lookup_matches_pallas_interpret_and_zrun():
    """The Pallas lookup kernel (interpret mode; its bands fit: ok) on keys
    shifted by small packed deltas, the kernel-map pattern; and zrun_rank
    with kz = 1: position = rank where bit 0 is set."""
    keys = _real_level1_keys()
    c = keys.shape[1]
    deltas = np.array([0, 1, -1, 2048, -2048], np.int32)
    queries = np.stack([np.where(keys != MAXKEY, keys + d, MAXKEY) for d in deltas],
                       axis=1).astype(np.int32)
    want, ok = jbanded.banded_lookup(jnp.asarray(keys), jnp.asarray(queries), interpret=True)
    assert bool(ok)
    keys_t, q_t = torch.from_numpy(keys), torch.from_numpy(queries)
    got = kernels.lookup(keys_t, q_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bits, rank = kernels.zrun_rank(keys_t, q_t, 1)
    np.testing.assert_array_equal(got.numpy(), torch.where(bits > 0, rank, c).numpy())
    assert int((got[:, 0] < c).sum()) == int((keys != MAXKEY).sum())


@pytest.mark.parametrize("level,k,scale", [(1, 2, 2), (2, 2, 2), (1, 3, 1), (0, 5, 1)])
def test_kmap_queries_match_jax(level, k, scale):
    """Down-map queries (k=2 s=2, into level l-1's key space) and self-map
    queries (odd k, s=1) of real pyramid levels."""
    jp, tp, jspec, tspec = _pyramids(0, up_levels=jpyr.egonn_pyramid_spec(
        cap0=1024, num_levels=3).up_levels)
    pack = tspec.pack_at(level - 1 if scale == 2 else level)
    lo = -(k // 2) if k % 2 else 0
    want = jax.vmap(lambda c, m: jpyr._kmap_queries(c, m, jpyr._xy_offsets(k), k, lo, scale,
                                                    pack))(jp[level].coords, jp[level].mask)
    got = tpacking.kmap_queries(tp[level].coords, tp[level].mask, k, scale, pack)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got != MAXKEY).sum()) > 0


def _pyramids(seed, up_levels, cap0=1024, num_levels=3, canonical=True):
    """JAX and port pyramids of the same clouds (tests/test_torch_pyramid.py's
    cloud shape) under the EgoNN spec with the given up levels."""
    rng = np.random.default_rng(seed)
    b, n = 2, 4096
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = np.abs(rng.normal(25, 18, (b, n))).clip(2, 80)
    z = rng.uniform(-1, 10, (b, n))
    clouds = np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 3500:] = False
    jspec = dataclasses.replace(jpyr.egonn_pyramid_spec(cap0=cap0, num_levels=num_levels),
                                up_levels=tuple(up_levels))
    tspec = dataclasses.replace(tpyr.egonn_pyramid_spec(cap0=cap0, num_levels=num_levels),
                                up_levels=tuple(up_levels))
    jq = JPolar(STEPS)
    if not canonical:
        raw = jax.vmap(jq.to_polar_voxels)(jnp.asarray(clouds))
        jp = jax.jit(lambda c, m: jpyr.build_pyramid(c, m, jspec))(raw, jnp.asarray(mask))
        tp = tpyr.build_pyramid(torch.from_numpy(np.array(raw)), torch.from_numpy(mask), tspec)
        return jp, tp, jspec, tspec
    res = jax.vmap(lambda p, m: jq.quantize(p, m, jspec.capacities[0], need_index=False))(
        jnp.asarray(clouds), jnp.asarray(mask))
    jp = jax.jit(lambda c, m, k: jpyr.build_pyramid(c, m, jspec, keys0=k))(
        res.coords_t, res.mask, res.keys)
    coords, m0, keys = (torch.from_numpy(np.array(a)) for a in (res.coords_t, res.mask, res.keys))
    tp = tpyr.build_pyramid(coords, m0, tspec, keys0=keys)
    return jp, tp, jspec, tspec


@pytest.mark.parametrize("seed,cap0,canonical", [(0, 1024, True), (1, 512, True),
                                                 (2, 1024, False)])
def test_lookup_kmap_down_matches_jax_and_invert_up(seed, cap0, canonical):
    """With no up maps every level's kmap_down comes from the lookup: bit-equal
    to JAX's at every level, and to the port's inverted up map of the full
    EgoNN spec.  cap0 512 overflows the finer levels, so dropped voxels are
    covered too."""
    jp, tp, _, tspec = _pyramids(seed, (), cap0=cap0, canonical=canonical)
    full = dataclasses.replace(tspec, up_levels=(0, 1, 2))
    tp_full = tpyr.build_pyramid(tp[0].coords, tp[0].mask, full, with_kmap_down=True,
                                 keys0=tpacking.pack_keys(tp[0].coords, tp[0].mask))
    assert tp[0].kmap_down is None
    for l in range(1, tspec.num_levels + 1):
        got = tp[l].kmap_down
        assert got.shape == (2, 8, tspec.capacities[l]) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jp[l].kmap_down), err_msg=f"L{l}")
        assert torch.equal(got, tp_full[l].kmap_down), f"L{l} lookup vs invert_up"
        assert int((got < tspec.capacities[l - 1]).sum()) > int(tp[l].mask.sum())
        assert tp[l].up_parent is None
    if cap0 == 512:
        report = tpyr.capacity_report(tp, tspec)
        assert not all(ok for _, _, ok in report.values()), report



def _raw_pyramids(up_levels):
    """JAX and port pyramids of raw integer coords (not canonical), 4
    levels: cloud 0 spread over [-20, 20)^3, cloud 1 inside [0, 8)^3, so its
    level 3 and 4 hold one voxel each."""
    rng = np.random.default_rng(5)
    cap = 512
    coords = np.concatenate([rng.integers(-20, 20, size=(1, 3, cap)),
                             rng.integers(0, 8, size=(1, 3, cap))]).astype(np.int32)
    mask = np.ones((2, cap), bool)
    mask[1, 300:] = False
    kw = dict(capacities=(cap, 384, 256, 256, 256), conv0_kernel_size=3,
              self_levels=(1, 2, 3, 4), up_levels=tuple(up_levels))
    jspec, tspec = jpyr.PyramidSpec(**kw), tpyr.PyramidSpec(**kw)
    jp = jax.jit(lambda c, m: jpyr.build_pyramid(c, m, jspec))(jnp.asarray(coords),
                                                               jnp.asarray(mask))
    tp = tpyr.build_pyramid(torch.from_numpy(coords), torch.from_numpy(mask), tspec)
    return jp, tp, jspec, tspec


def _port_keys(tp, tspec):
    return [tpacking.pack_keys(tp[l].coords, tp[l].mask, tspec.pack_at(l))
            for l in range(tspec.num_levels + 1)]


@pytest.mark.parametrize("up_levels", [(), (1, 3), (0, 2)])
def test_lookup_down_plain_matches_jax(up_levels):
    """`lookup_down_plain` (the CPU path of the grouped lookup) at every level
    whose finer level records no up map, several in one call, against JAX's
    `_kmap_queries` + `lookup_sorted` on JAX's own pyramid, and against the
    kmap_down of both pyramids; specs with no, alternate and other
    recorded up maps; one cloud's levels 3 and 4 hold a single voxel."""
    jp, tp, jspec, tspec = _raw_pyramids(up_levels)
    levels = [l for l in range(1, 5) if l - 1 not in up_levels]
    assert int(tp[3].mask[1].sum()) == 1 and int(tp[4].mask[1].sum()) == 1
    keys = _port_keys(tp, tspec)
    got = kernels.lookup_down_plain(keys, [tspec.pack_at(l) for l in range(5)], levels)
    assert len(got) == len(levels)
    offsets = jpyr._xy_offsets(2)
    for l, g in zip(levels, got):
        pack = jspec.pack_at(l - 1)
        jkeys = jax.vmap(lambda c, m: jpacking.pack_keys(c, m, pack))(jp[l - 1].coords,
                                                                      jp[l - 1].mask)
        q = jax.vmap(lambda c, m: jpyr._kmap_queries(c, m, offsets, 2, 0, 2, pack))(
            jp[l].coords, jp[l].mask)
        want = _j_lookup(np.asarray(jkeys), np.asarray(q))
        assert g.dtype == torch.int32 and g.shape == want.shape
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"L{l}")
        np.testing.assert_array_equal(g.numpy(), np.asarray(jp[l].kmap_down), err_msg=f"L{l}")
        assert torch.equal(g, tp[l].kmap_down), f"L{l}"
        assert int((g[1] < tspec.capacities[l - 1]).sum()) >= int(tp[l].mask[1].sum())
    for l in range(1, 5):
        if l not in levels:
            assert tp[l].kmap_down is None


@pytest.mark.parametrize("seed,cap0", [(0, 1024), (1, 512)])
def test_down_queries_sorted_per_offset(seed, cap0):
    """The invariant the lookup kernel's speed rests on: for each offset, the
    down-map queries of a sorted coarse level are non-decreasing over its
    valid rows (doubling a packed key keeps its order), every valid row's
    children are in range, and padding rows give MAXKEY.  So a tile of rows
    needs one run of the finer table."""
    _, tp, _, tspec = _pyramids(seed, (), cap0=cap0)
    keys = _port_keys(tp, tspec)
    for l in range(1, tspec.num_levels + 1):
        q = kernels.down_queries(keys[l], tspec.pack_at(l), tspec.pack_at(l - 1))
        np.testing.assert_array_equal(
            q.numpy(), tpacking.kmap_queries(tp[l].coords, tp[l].mask, 2, 2,
                                             tspec.pack_at(l - 1)).numpy())
        for b in range(q.shape[0]):
            n = int(tp[l].mask[b].sum())
            valid = q[b, :, :n].long()
            assert bool((valid != MAXKEY).all()), f"L{l}"
            assert bool((valid[:, 1:] >= valid[:, :-1]).all()), f"L{l} cloud {b}"
            assert bool((q[b, :, n:] == MAXKEY).all())
