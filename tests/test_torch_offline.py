"""Port vs JAX: the offline tools (host numpy) on the JAX tests' fixtures.

* the tuple / evaluation-set generators (`data/generate_mulran.py` with ICP
  refinement, `generate_kitti.py`, `generate_southbay.py`) and the sequence
  classes under them, on tests/test_generators.py's miniature dataset trees:
  every tuple and evaluation element equal to JAX's, the pickles holding the
  port's classes;
* the on-disk quirks of tests/test_real_formats.py: MulRan pose CSVs,
  SouthBay binary_compressed PCDs (the native LZF decoder), KITTI poses and
  times;
* the native LZF decoder against the plain Python one;
* ScanContext (tests/test_scan_context.py's clouds) and its CLI against the
  repository's `evaluate_scan_context.py`;
* the visualization helpers write their PNGs.
"""
import os
import pickle
import struct
import sys

import numpy as np
import pytest

from test_generators import kitti_root, mulran_root, southbay_root  # noqa: F401  (fixtures)

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu_torch.data import base as tbase
from egonn_tpu_torch.data import pcd as tpcd
from egonn_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_tuples(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        w = want[k]
        assert type(t) is tbase.TrainingTuple
        assert (t.id, t.timestamp, t.rel_scan_filepath) == (w.id, w.timestamp,
                                                             w.rel_scan_filepath), k
        for f in ("positives", "non_negatives", "pose"):
            np.testing.assert_array_equal(getattr(t, f), getattr(w, f), err_msg=f"{k} {f}")
        if w.positives_poses is None:
            assert t.positives_poses is None
        else:
            assert sorted(t.positives_poses) == sorted(w.positives_poses)
            for p, m in w.positives_poses.items():
                np.testing.assert_allclose(t.positives_poses[p], m, rtol=0, atol=1e-9)


def _same_eval_sets(got_path: str, want_path: str):
    got, want = tbase.EvaluationSet(), tbase.EvaluationSet()
    got.load(got_path)
    want.load(want_path)
    for g_set, w_set in ((got.map_set, want.map_set), (got.query_set, want.query_set)):
        assert len(g_set) == len(w_set) > 0
        for g, w in zip(g_set, w_set):
            assert (g.timestamp, g.rel_scan_filepath) == (w.timestamp, w.rel_scan_filepath)
            np.testing.assert_array_equal(g.position, w.position)
            np.testing.assert_array_equal(g.pose, w.pose)


def _run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("icp", [False, True])
def test_mulran_tuples_match_jax(mulran_root, icp):
    from egonn_tpu.data import generate_mulran as jgen
    from egonn_tpu.data import mulran as jmulran
    from egonn_tpu_torch.data import generate_mulran as tgen
    from egonn_tpu_torch.data import mulran as tmulran

    seqs = ["Sejong01"] if icp else ["Sejong01", "Sejong02"]
    for split in ("train", "test"):
        jds = jmulran.MulranSequences(mulran_root, seqs, split=split)
        tds = tmulran.MulranSequences(mulran_root, seqs, split=split)
        assert len(tds) == len(jds) and tds.rel_scan_filepath == jds.rel_scan_filepath
        np.testing.assert_array_equal(tds.poses, jds.poses)
        np.testing.assert_array_equal(tds.timestamps, jds.timestamps)
        _same_tuples(tgen.generate_training_tuples(tds, 2, 10, icp_refine=icp),
                     jgen.generate_training_tuples(jds, 2, 10, icp_refine=icp))


def test_mulran_eval_set_cli_matches_jax(mulran_root, monkeypatch):
    from egonn_tpu.data import generate_mulran as jgen
    from egonn_tpu_torch.data import generate_mulran as tgen

    path = os.path.join(mulran_root, "test_Sejong01_Sejong02.pickle")
    _run_main(jgen, ["--dataset_root", mulran_root, "--eval_sets"], monkeypatch)
    os.rename(path, path + ".jax")
    _run_main(tgen, ["--dataset_root", mulran_root, "--eval_sets"], monkeypatch)
    _same_eval_sets(path, path + ".jax")
    _run_main(tgen, ["--dataset_root", mulran_root, "--no_icp"], monkeypatch)
    got = tbase.load_training_tuples(os.path.join(mulran_root,
                                                  "train_Sejong01_Sejong02_2_10.pickle"))
    assert len(got) == 8 and all(type(t) is tbase.TrainingTuple for t in got.values())


def test_kitti_eval_set_matches_jax(kitti_root, monkeypatch):
    from egonn_tpu.data import generate_kitti as jgen
    from egonn_tpu_torch.data import generate_kitti as tgen

    path = os.path.join(kitti_root, "kitti_00_eval.pickle")
    _run_main(jgen, ["--dataset_root", kitti_root], monkeypatch)
    os.rename(path, path + ".jax")
    _run_main(tgen, ["--dataset_root", kitti_root], monkeypatch)
    _same_eval_sets(path, path + ".jax")


def test_southbay_tuples_and_eval_match_jax(southbay_root, monkeypatch):
    from egonn_tpu.data import generate_southbay as jgen
    from egonn_tpu_torch.data import generate_southbay as tgen

    train = os.path.join(southbay_root, "train_southbay_2_10.pickle")
    test = os.path.join(southbay_root, "test_SunnyvaleBigloop_1.0_5.pickle")
    for gen, suffix in ((jgen, ".jax"), (tgen, "")):
        _run_main(gen, ["--dataset_root", southbay_root], monkeypatch)
        _run_main(gen, ["--dataset_root", southbay_root, "--eval_sets", "--pos_th", "2",
                        "--neg_th", "10"], monkeypatch)
        if suffix:
            os.rename(train, train + suffix)
            os.rename(test, test + suffix)
    with open(train + ".jax", "rb") as f:
        want = pickle.load(f)
    got = tbase.load_training_tuples(train)
    assert len(got) > 0
    _same_tuples(got, want)
    _same_eval_sets(test, test + ".jax")


# ---------------------------------------------------------------------------
# on-disk formats
# ---------------------------------------------------------------------------

def test_mulran_pose_csv_matches_jax(tmp_path):
    from egonn_tpu.data.mulran import read_lidar_poses as j_read
    from egonn_tpu_torch.data.mulran import FAULTY_POINTCLOUDS, read_lidar_poses

    scans = tmp_path / "Ouster"
    scans.mkdir()
    sec = 1_000_000_000
    for ts in (10 * sec, 20 * sec, 30 * sec, 90 * sec, FAULTY_POINTCLOUDS[0]):
        np.zeros((8, 4), np.float32).tofile(scans / f"{ts}.bin")
    (scans / "notes.txt").write_text("not a scan")

    def row(ts, tx):
        return f" {ts} , 1,0,0, {tx} ,0, 1 ,0,2.5,0,0,1,  -3.0 \n"

    csv = tmp_path / "global_pose.csv"
    csv.write_text(row(20 * sec + sec // 10, 111.0) + row(10 * sec, 100.0) + row(30 * sec, 122.0))
    ts, poses = read_lidar_poses(str(csv), str(scans))
    j_ts, j_poses = j_read(str(csv), str(scans))
    assert ts.tolist() == j_ts.tolist() == [10 * sec, 20 * sec, 30 * sec]
    np.testing.assert_array_equal(poses, j_poses)
    csv.write_text("1000000000,1,0,0,0,0,1,0,0,0,0,1\n")  # 12 fields, not 13
    with pytest.raises(AssertionError):
        read_lidar_poses(str(csv), str(scans))


def _southbay_pcd(path, n=5):
    """test_real_formats.py's Apollo-SouthBay PCD: a count-2 field, a '_'
    padding field, a NaN row, field-major LZF, junk after the payload."""
    x = np.array([1.0, 2.0, np.nan, 4.0, 5.0], np.float32)
    y = np.array([10.0, 20.0, 30.0, 40.0, 50.0], np.float32)
    z = np.array([-1.0, -2.0, -3.0, -4.0, 9.0], np.float32)
    inten2 = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              "FIELDS x y z intensity _\nSIZE 4 4 4 4 4\nTYPE F F F F U\n"
              "COUNT 1 1 1 2 1\nWIDTH 5\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              "POINTS 5\nDATA binary_compressed\n")
    raw = (x.tobytes() + y.tobytes() + z.tobytes()
           + np.ascontiguousarray(inten2[:, 0]).tobytes()
           + np.ascontiguousarray(inten2[:, 1]).tobytes() + np.zeros(n, np.uint32).tobytes())
    comp = tpcd.lzf_compress(raw)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(struct.pack("II", len(comp), len(raw)))
        f.write(comp)
        f.write(b"\x00JUNK-PCL-PADS-FILES")


def test_southbay_pcd_matches_jax(tmp_path):
    from egonn_tpu.data.pcd import read_pcd as j_read_pcd
    from egonn_tpu.data.southbay import SouthbayPointCloudLoader as JLoader
    from egonn_tpu_torch.data.southbay import SouthbayPointCloudLoader

    path = tmp_path / "southbay.pcd"
    _southbay_pcd(path)
    arr, meta = tpcd.read_pcd(str(path))
    j_arr, j_meta = j_read_pcd(str(path))
    assert meta == j_meta and arr.dtype == j_arr.dtype
    for name in arr.dtype.names:
        np.testing.assert_array_equal(arr[name], j_arr[name], err_msg=name)
    pc = SouthbayPointCloudLoader()(str(path))
    np.testing.assert_array_equal(pc, JLoader()(str(path)))
    assert not np.isnan(pc).any() and [1.0, 10.0, -1.0] in pc.tolist()
    ascii_pcd = tmp_path / "a.pcd"
    ascii_pcd.write_text("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                         "WIDTH 3\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 3\nDATA ascii\n"
                         "1.0 2.0 3.0\nnan nan nan\n-1.5 0.25 7e-1\n")
    np.testing.assert_array_equal(tpcd.read_pcd_xyz(str(ascii_pcd)),
                                  np.stack([j_read_pcd(str(ascii_pcd))[0][k]
                                            for k in "xyz"], 1))


def test_kitti_sequence_matches_jax(tmp_path):
    from egonn_tpu.data.kitti import KittiSequence as JKittiSequence
    from egonn_tpu_torch.data.kitti import KittiSequence

    seq = tmp_path / "sequences" / "00"
    (seq / "velodyne").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    np.array([[1, 2, 3, 0.5], [4, 5, 6, 0.1]], np.float32).tofile(seq / "velodyne" / "000000.bin")
    np.array([[0, 0, 0, 0.0], [7, 8, 9, 0.2], [0, 0, 0, 0.9]],
             np.float32).tofile(seq / "velodyne" / "000001.bin")
    (tmp_path / "poses" / "00.txt").write_text("1 0 0 0 0 1 0 0 0 0 1 0\n"
                                                "1 0 0 1.5 0 1 0 0 0 0 1 -2.25\n")
    (seq / "times.txt").write_text("0.0\n1.038\n")
    ks, jks = KittiSequence(str(tmp_path), "00"), JKittiSequence(str(tmp_path), "00")
    assert len(ks) == len(jks) == 2 and ks.rel_scan_filepath == jks.rel_scan_filepath
    np.testing.assert_array_equal(ks.rel_lidar_timestamps, jks.rel_lidar_timestamps)
    for i in range(2):
        for k in ("pc", "pose", "ts"):
            np.testing.assert_array_equal(ks[i][k], jks[i][k], err_msg=f"{i} {k}")
    np.testing.assert_array_equal(ks[1]["pc"], [[7, 8, 9]])


# ---------------------------------------------------------------------------
# native LZF
# ---------------------------------------------------------------------------

def test_native_lzf_matches_plain(rng):
    """Literal runs (1 MiB of random bytes), short and long back-references,
    and the errors: ValueError from both decoders."""
    data = rng.integers(0, 255, 1 << 20, dtype=np.uint8).tobytes()
    stream = tpcd.lzf_compress(data)
    assert native.lzf_decompress(stream, len(data)) == data
    refs = bytes([5]) + b"abcabc" + bytes([(4 << 5) | 0, 5]) + bytes([(7 << 5), 3, 11])
    want = tpcd.lzf_decompress_plain(refs, 24)
    assert native.lzf_decompress(refs, 24) == want and len(want) == 24
    assert native.lzf_decompress(b"", 0) == b""
    for bad, size in ((refs, 25), (refs, 23), (bytes([(1 << 5) | 0, 9]), 3), (bytes([7]), 8)):
        with pytest.raises(ValueError):
            tpcd.lzf_decompress_plain(bad, size)
        with pytest.raises(ValueError):
            native.lzf_decompress(bad, size)
    lib = native.build("lzf.cpp")
    assert lib.parent == native.BUILD_DIR and lib.exists()


# ---------------------------------------------------------------------------
# ScanContext and visualization
# ---------------------------------------------------------------------------

def test_scan_context_matches_jax(rng):
    from egonn_tpu.eval import scan_context as jsc
    from egonn_tpu_torch.eval import scan_context as tsc

    pts = np.stack([rng.uniform(-90, 90, 3000), rng.uniform(-90, 90, 3000),
                    rng.uniform(-3, 6, 3000)], 1)
    for a, b in zip(tsc.pt2rs(pts, 4.0, 2 * np.pi / 60), jsc.pt2rs(pts, 4.0, 2 * np.pi / 60)):
        np.testing.assert_array_equal(a, b)
    sc_t, sc_j = tsc.ScanContext()(pts), jsc.ScanContext()(pts)
    np.testing.assert_array_equal(sc_t, sc_j)
    np.testing.assert_array_equal(tsc.sc2rk(sc_t), jsc.sc2rk(sc_j))
    c, s = np.cos(0.7), np.sin(0.7)
    rot = pts @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
    assert tsc.distance_sc(sc_t, tsc.ScanContext()(rot)) == jsc.distance_sc(
        sc_j, jsc.ScanContext()(rot))
    managers = [m.ScanContextManager(max_capacity=16) for m in (tsc, jsc)]
    for i in range(6):
        cloud = np.stack([rng.uniform(-60, 60, 500), rng.uniform(-60, 60, 500),
                          rng.uniform(-2, 5, 500)], 1)
        for m in managers:
            m.add_node(cloud)
    for got, want in zip(managers[0].query(rot, k=3), managers[1].query(rot, k=3)):
        np.testing.assert_array_equal(got, want)


def test_scan_context_cli_matches_repository_cli(tmp_path, monkeypatch, capsys):
    import importlib.util

    from egonn_tpu_torch import evaluate_scan_context
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset

    root = str(tmp_path / "synth")
    _, _, eval_file = generate_synthetic_dataset(root, n_scans=16, extent=60.0,
                                                 scan_radius=40.0, max_points=2048, seed=0)
    args = ["--dataset_root", root, "--dataset_type", "synthetic", "--eval_set", eval_file,
            "--k", "5"]
    spec = importlib.util.spec_from_file_location(
        "repository_evaluate_scan_context", os.path.join(ROOT, "evaluate_scan_context.py"))
    repo_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(repo_cli)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["evaluate_scan_context.py"] + args)
    repo_cli.main()
    want = capsys.readouterr().out
    evaluate_scan_context.main(args)
    got = capsys.readouterr().out
    assert "Recall@1" in got and got == want


def test_visualize_writes_pngs(tmp_path, rng):
    from egonn_tpu_torch.utils.visualize import draw_pc, draw_registration_result

    pc = rng.normal(0, 5, (300, 3))
    t = np.eye(4)
    t[:3, 3] = [1.0, 2.0, 0.5]
    for path in (draw_pc(pc, str(tmp_path / "pc.png")),
                 draw_registration_result(pc, pc + 1.0, t, str(tmp_path / "reg.png"),
                                          keypoints=pc[:10])):
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
