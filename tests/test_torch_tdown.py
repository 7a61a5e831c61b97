"""What the tdown and z-run kernels of the port rely on, on the CPU.

- `kernels.tdown_hulls_plain`, the hull of fine rows feeding each coarse
  tile (the tdown kernel's first launch computes the same): against a numpy
  brute force, every child of a tile inside its hull, on near-monotone,
  dropped and shuffled up maps; and against the JAX package's own formula
  (`egonn_tpu/sparse/banded.py::tdown_layout`, jax.lax.cummax / cummin) on
  the up maps of EgoNN and MinkLoc pyramids.
- The z-run kernels read a slice of the key table per chunk of a row's
  queries, which is short because each (cloud, xy offset) row of
  `pyramid._zrun_queries` is sorted over its valid entries: checked at
  every self-map level of both pyramids.
- The launch rules `tdown_tiling` and `zrun_chunk`.

The kernels themselves run on the card: `tests/test_torch_kernels.py -m cuda`.
"""
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu_torch.config import ModelParams
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import model_factory
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.packing import MAXKEY

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _pyramid(kind: str):
    """An EgoNN (7 levels, cap0 2048) or MinkLoc (minkloc3d_mulran.txt's
    spec, cap0 4096) pyramid of 2 lidar_sim clouds of 8,192 points."""
    clouds = torch.from_numpy(lidar_scan_clouds(2, 8192, seed=5))
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    if kind == "egonn":
        quantizer, spec = PolarQuantizer([1.0, 0.3, 0.2]), tpyr.egonn_pyramid_spec(cap0=2048)
    else:
        mp = ModelParams(str(ROOT / "model_configs" / "minkloc3d_mulran.txt"))
        built = model_factory(mp, cap0=4096, device="cpu")
        quantizer, spec = built.quantizer, built.pyramid_spec
    res = quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    return tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec


def _brute_hulls(parent: np.ndarray, c_coarse: int, rows: int) -> np.ndarray:
    """[first, end) per tile straight from the definition: running max of
    the parents from the start, running min from the end, counted against
    the tile's bounds."""
    b, c = parent.shape
    n_tiles = -(-c_coarse // rows)
    out = np.zeros((b, n_tiles, 2), np.int64)
    for i in range(b):
        valid = (parent[i] >= 0) & (parent[i] < c_coarse)
        m, rm = np.zeros(c, np.int64), np.zeros(c, np.int64)
        run = -1
        for j in range(c):
            run = max(run, parent[i, j] if valid[j] else -1)
            m[j] = run
        run = 1 << 30
        for j in range(c - 1, -1, -1):
            run = min(run, parent[i, j] if valid[j] else 1 << 30)
            rm[j] = run
        for t in range(n_tiles):
            out[i, t] = (m < t * rows).sum(), (rm < (t + 1) * rows).sum()
    return out


def _up_map(kind: str, gen, b=2, c_fine=1500, c_coarse=700):
    """Parents as a key-sorted fine table gives them (near-monotone), some
    dropped by capacity (parent c_coarse), or shuffled."""
    parent = np.sort(gen.integers(0, c_coarse, size=(b, c_fine)), axis=1)
    parent = np.minimum(parent + gen.integers(-3, 4, size=parent.shape), c_coarse - 1)
    parent = np.maximum(parent, 0)
    if kind == "dropped":
        parent[:, -200:] = c_coarse
        parent[:, 100:140] = c_coarse
    elif kind == "shuffled":
        parent = gen.permuted(parent, axis=1)
    return parent.astype(np.int32)


@pytest.mark.parametrize("rows", [32, 64, 128])
@pytest.mark.parametrize("kind", ["sorted", "dropped", "shuffled"])
def test_tdown_hulls_plain_matches_brute_force(rows, kind):
    gen = np.random.default_rng(rows)
    c_coarse = 700
    parent = _up_map(kind, gen, c_coarse=c_coarse)
    hulls = kernels.tdown_hulls_plain(torch.from_numpy(parent), c_coarse, rows).numpy()
    np.testing.assert_array_equal(hulls, _brute_hulls(parent, c_coarse, rows))
    for i, j in zip(*np.nonzero(parent < c_coarse)):  # every child inside its tile's hull
        first, end = hulls[i, parent[i, j] // rows]
        assert first <= j < end
    if kind == "shuffled":  # a hull may span most of the table: slow, still exact
        assert (hulls[..., 1] - hulls[..., 0]).max() > parent.shape[1] // 2


def _jax_hulls(up_parent: np.ndarray, c_coarse: int, rows: int) -> np.ndarray:
    """tdown_layout's first / end (egonn_tpu/sparse/banded.py:466-480) with
    tile = rows, before its 128-row alignment."""
    up_parent = jnp.asarray(up_parent)
    t = -(-c_coarse // rows)
    valid = up_parent < c_coarse
    lo = jnp.where(valid, up_parent, -1)
    m = jax.lax.cummax(lo, axis=1)
    hi = jnp.where(valid, up_parent, jnp.int32(2**30))
    rm = jnp.flip(jax.lax.cummin(jnp.flip(hi, 1), axis=1), 1)
    bounds = jnp.arange(t, dtype=jnp.int32) * rows
    first = jnp.sum(m[:, :, None] < bounds[None, None, :], axis=1, dtype=jnp.int32)
    end = jnp.sum(rm[:, :, None] < (bounds + rows)[None, None, :], axis=1, dtype=jnp.int32)
    return np.stack([np.asarray(first), np.asarray(end)], axis=2)


@pytest.mark.parametrize("kind", ["egonn", "minkloc"])
def test_tdown_hulls_match_jax_at_pyramid_levels(kind):
    pyr, spec = _pyramid(kind)
    for l in spec.up_levels:
        up_parent = pyr[l].up_parent
        c_coarse = spec.capacities[l + 1]
        for rows in (32, 64, 128):
            hulls = kernels.tdown_hulls_plain(up_parent, c_coarse, rows).numpy()
            np.testing.assert_array_equal(hulls, _jax_hulls(up_parent.numpy(), c_coarse, rows),
                                          err_msg=f"{kind} L{l}->L{l + 1} rows {rows}")
        # near-monotone parents: a 128-row tile's hull is not much more than its children
        hulls = kernels.tdown_hulls_plain(up_parent, c_coarse, 128).numpy()
        span = np.maximum(hulls[..., 1] - hulls[..., 0], 0).sum()
        children = int((up_parent < c_coarse).sum())
        assert children <= span <= 2 * children


@pytest.mark.parametrize("kind", ["egonn", "minkloc"])
def test_zrun_query_rows_sorted(kind):
    """Every (cloud, xy offset) row of z-run queries is non-decreasing over
    its valid entries, at every self-map level."""
    pyr, spec = _pyramid(kind)
    for l in (0,) + tuple(spec.self_levels):
        k = spec.conv0_kernel_size if l == 0 else spec.block_kernel_size
        q_lo, _, _ = tpyr._zrun_queries(pyr[l].coords, pyr[l].mask, k, spec.pack_at(l))
        rows = q_lo.reshape(-1, q_lo.shape[2]).numpy()
        n_valid = 0
        for row in rows:
            valid = row[row != MAXKEY].astype(np.int64)
            n_valid += valid.size
            assert np.all(np.diff(valid) >= 0), f"{kind} L{l}: a query row out of order"
        assert n_valid > 0


# (B, C_fine, F_in, F_out) of the forward's, validation step's and MinkLoc's
# down convs, and of the cuda tests'
_TDOWN_CALLS = [(8, 16384, 32, 32), (8, 6656, 64, 64), (8, 2560, 128, 128), (8, 1408, 128, 128),
                (32, 2560, 128, 128), (32, 1408, 128, 128), (8, 40960, 32, 32), (2, 3000, 512, 512),
                (3, 2000, 36, 64), (1, 64, 4, 32)]


@pytest.mark.parametrize("b,c_fine,f_in,f_out", _TDOWN_CALLS)
def test_tdown_tiling(b, c_fine, f_in, f_out):
    """The rule's tiling is one the kernel takes; the gathering body for
    narrow or large calls, the streaming body for small wide ones."""
    rows, rc, gather = kernels.tdown_tiling(b, c_fine, f_in)
    assert kernels.tdown_tiling_ok(f_in, f_out, rows, rc, gather)
    assert gather == (f_in <= 64 or b * c_fine >= 49152)


@pytest.mark.parametrize("n_row", [16384, 16385, 9856, 8192, 1024, 5])
def test_zrun_chunk(n_row):
    """512 or 1024 queries a block (the kernel takes 1 to 1024), 1024 on rows
    of 8,192 or more."""
    q = kernels.zrun_chunk(n_row)
    assert q in (512, 1024) and (q == 1024) == (n_row >= 8192)
