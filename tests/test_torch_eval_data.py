"""Port vs JAX: the evaluation's data layer (evaluation-set pickles, PCD / LZF,
the four point-cloud loaders, the synthetic dataset, the point budget) on
the same files."""
import os
import pickle
import types

import numpy as np
import pytest

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.data import base as jb
from egonn_tpu.data import pcd as jpcd
from egonn_tpu.data.pipeline import default_num_points as j_default_num_points
from egonn_tpu.data.pipeline import resolve_num_points as j_resolve_num_points
from egonn_tpu.data.synthetic import generate_synthetic_dataset as j_generate
from egonn_tpu.utils.native import _lzf_decompress_py, lzf_compress_py
from egonn_tpu_torch.data import base as tb
from egonn_tpu_torch.data import pcd as tpcd
from egonn_tpu_torch.data.pipeline import default_num_points, resolve_num_points
from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset


def _eval_tuples(module, rng, n):
    return [module.EvaluationTuple(int(i), f"scans/{i:06d}.bin",
                                   rng.uniform(-100, 100, 2).astype(np.float32),
                                   rng.standard_normal((4, 4))) for i in range(n)]


def _same_sets(a, b):
    for x, y in zip(a.query_set + a.map_set, b.query_set + b.map_set):
        assert (x.timestamp, x.rel_scan_filepath) == (y.timestamp, y.rel_scan_filepath)
        np.testing.assert_array_equal(x.position, y.position)
        np.testing.assert_array_equal(x.pose, y.pose)
    assert (len(a.query_set), len(a.map_set)) == (len(b.query_set), len(b.map_set))


def test_evaluation_set_pickles_cross_load(tmp_path, rng):
    j_set = jb.EvaluationSet(_eval_tuples(jb, rng, 3), _eval_tuples(jb, rng, 5))
    j_set.save(str(tmp_path / "j.pickle"))
    t_set = tb.EvaluationSet()
    t_set.load(str(tmp_path / "j.pickle"))
    _same_sets(t_set, j_set)
    np.testing.assert_array_equal(t_set.get_map_positions(), j_set.get_map_positions())
    np.testing.assert_array_equal(t_set.get_query_positions(), j_set.get_query_positions())
    t_set.save(str(tmp_path / "t.pickle"))
    assert (tmp_path / "t.pickle").read_bytes() == (tmp_path / "j.pickle").read_bytes()
    back = jb.EvaluationSet()
    back.load(str(tmp_path / "t.pickle"))
    _same_sets(back, j_set)
    with pytest.raises(ValueError, match="position"):
        tb.EvaluationTuple(0, "x.bin", np.zeros(3))


def test_in_sorted_array():
    """The port's vectorized `in_sorted` against JAX's `in_sorted_array`, per
    value, on a sorted and an empty array."""
    values = np.array([-1, 1, 4, 5, 9, 12, 13])
    for arr in (np.array([1, 4, 9, 12]), np.array([], np.int64)):
        assert tb.in_sorted(values, arr).tolist() == [jb.in_sorted_array(int(e), arr)
                                                      for e in values]


def test_lzf_matches_jax(rng):
    data = rng.integers(0, 255, 1000, dtype=np.uint8).tobytes()
    assert tpcd.lzf_compress(data) == lzf_compress_py(data)
    assert tpcd.lzf_decompress_plain(lzf_compress_py(data), len(data)) == data
    # back-references: literal "abcabc" then a copy of 6 bytes from 6 back,
    # and a long one (length field 7 + extra byte)
    stream = bytes([5]) + b"abcabc" + bytes([(4 << 5) | 0, 5]) + bytes([(7 << 5), 3, 11])
    want = _lzf_decompress_py(stream, 6 + 6 + 12)
    assert tpcd.lzf_decompress_plain(stream, len(want)) == want
    with pytest.raises(ValueError, match="expected"):
        tpcd.lzf_decompress_plain(stream, len(want) + 1)
    with pytest.raises(ValueError, match="back-reference"):
        tpcd.lzf_decompress_plain(bytes([(1 << 5) | 0, 9]), 3)


def _cloud(rng, n=500):
    pc = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pc[:20] = 0.0          # zero points
    pc[20:60, 2] = -3.0    # below every ground plane
    return pc


def test_pcd_readers_and_writers_match_jax(tmp_path, rng):
    xyz = _cloud(rng)
    for kind in ("binary", "binary_compressed"):
        t_path, j_path = tmp_path / f"t_{kind}.pcd", tmp_path / f"j_{kind}.pcd"
        getattr(tpcd, f"write_pcd_{kind}")(str(t_path), xyz)
        getattr(jpcd, f"write_pcd_{kind}")(str(j_path), xyz)
        assert t_path.read_bytes() == j_path.read_bytes(), kind
        got = tpcd.read_pcd_xyz(str(j_path))
        np.testing.assert_array_equal(got, jpcd.read_pcd_xyz(str(j_path)))
        np.testing.assert_array_equal(got, xyz)
    # ascii, with a COUNT > 1 field and a padding field
    path = tmp_path / "a.pcd"
    path.write_text("VERSION 0.7\nFIELDS x y z rgb _ _\nSIZE 4 4 4 4 1 1\nTYPE F F F U U U\n"
                    "COUNT 1 1 1 2 1 1\nWIDTH 2\nHEIGHT 1\nPOINTS 2\nDATA ascii\n"
                    "1 2 3 4 5 6 7\n-1.5 0 2.25 0 0 1 1\n")
    arr_t, meta_t = tpcd.read_pcd(str(path))
    arr_j, meta_j = jpcd.read_pcd(str(path))
    assert meta_t == meta_j and arr_t.dtype == arr_j.dtype
    np.testing.assert_array_equal(arr_t, arr_j)


@pytest.mark.parametrize("dataset_type", ["mulran", "kitti", "synthetic", "southbay"])
def test_loaders_match_jax(tmp_path, rng, dataset_type):
    xyz = _cloud(rng)
    if dataset_type == "southbay":
        xyz[60:70] = np.nan
        path = str(tmp_path / "scan.pcd")
        jpcd.write_pcd_binary_compressed(path, xyz)
    else:
        path = str(tmp_path / "scan.bin")
        np.concatenate([xyz, rng.random((len(xyz), 1), dtype=np.float32)], 1).tofile(path)
    got = tb.get_pointcloud_loader(dataset_type)(path)
    want = jb.get_pointcloud_loader(dataset_type)(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(xyz) - 60
    with pytest.raises(FileNotFoundError):
        tb.get_pointcloud_loader(dataset_type)(str(tmp_path / "missing.bin"))
    with pytest.raises(NotImplementedError):
        tb.get_pointcloud_loader("nuscenes")


def test_synthetic_dataset_equals_jax(tmp_path):
    """Scans and the evaluation pickle byte-equal for the same seed; the
    training-tuple pickles equal field by field (each holds its own
    package's TrainingTuple class, so the bytes name different modules)."""
    kw = dict(n_scans=12, extent=60.0, scan_radius=40.0, max_points=2048, seed=3)
    t_names = generate_synthetic_dataset(str(tmp_path / "t"), **kw)
    j_names = j_generate(str(tmp_path / "j"), **kw)
    assert t_names == j_names
    scans = sorted(os.listdir(tmp_path / "j" / "scans"))
    assert scans == sorted(os.listdir(tmp_path / "t" / "scans")) and len(scans) == 12
    for f in scans:
        assert (tmp_path / "t" / "scans" / f).read_bytes() == \
            (tmp_path / "j" / "scans" / f).read_bytes(), f
    eval_name = t_names[2]
    assert (tmp_path / "t" / eval_name).read_bytes() == (tmp_path / "j" / eval_name).read_bytes()
    for name in t_names[:2]:
        with open(tmp_path / "t" / name, "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / "j" / name, "rb") as f:
            want = pickle.load(f)
        assert list(got) == list(want)
        for k in want:
            assert isinstance(got[k], tb.TrainingTuple)
            g, w = vars(got[k]), vars(want[k])
            assert g.keys() == w.keys()
            for field in ("id", "timestamp", "rel_scan_filepath"):
                assert g[field] == w[field]
            for field in ("positives", "non_negatives", "pose"):
                np.testing.assert_array_equal(g[field], w[field])
                assert g[field].dtype == w[field].dtype
            assert list(g["positives_poses"]) == list(w["positives_poses"])
            for j in w["positives_poses"]:
                np.testing.assert_array_equal(g["positives_poses"][j], w["positives_poses"][j])
    # the scans load through the port's loader as through JAX's
    path = str(tmp_path / "t" / "scans" / scans[0])
    np.testing.assert_array_equal(tb.get_pointcloud_loader("synthetic")(path),
                                  jb.get_pointcloud_loader("synthetic")(path))


def test_num_points():
    for t in ("kitti", "KITTI", "mulran", "southbay", "synthetic"):
        assert default_num_points(t) == j_default_num_points(t)
    for explicit in (True, False):
        mp = types.SimpleNamespace(num_points=4096, num_points_explicit=explicit)
        for t in ("kitti", "mulran"):
            assert resolve_num_points(mp, t) == j_resolve_num_points(mp, t)
    assert resolve_num_points(types.SimpleNamespace(num_points=1000), "kitti") == 1000
