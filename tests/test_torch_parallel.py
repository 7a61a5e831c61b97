"""Port: data parallelism over torch.distributed ranks (`parallel/`), on the
CPU with gloo ranks: the calling process is rank 0, the others are spawned.

* `pad_batch_to_devices` against the JAX package's; rank rows;
* the dry run (`python -m egonn_tpu_torch.parallel.dryrun 2`): one combined
  train step with augmentation on over 2 ranks equals the single-process
  step (stats rel 1e-4, gradients 1e-3 of each leaf's max), the ranks'
  parameters, BatchNorm statistics and Adam moments bit-equal after it;
* the same on an odd global batch padded to an even bucket (padding rows
  with empty clouds and all-False masks);
* the sharded `Evaluator` (embeddings, local outputs) and
  `RotationEvaluator` (recalls) equal to the unsharded ones;
* a rank that raises makes `run_ranks` raise with its traceback.

The 2-rank step against JAX's unsharded step is in test_torch_train.py, and
`do_train` on a mesh of 2 in test_torch_train_loop.py.  Every rank joins
through a file in the test's temporary directory and waits at most
TIMEOUT_S in a collective; the JAX package is imported inside the tests
only, so that a spawned rank importing this module stays light.
"""
import numpy as np
import pytest
import torch

import torch_threads
from egonn_tpu_torch.parallel import dryrun, mesh

TIMEOUT_S = 120.0
CAP0, N_POINTS = 256, 512


@pytest.fixture(scope="module", autouse=True)
def _two_ranks():
    """The worker's threads split between the two ranks of each test."""
    with torch_threads.shared_by(2):
        yield


def _init(tmp_path, name="init"):
    return f"file://{tmp_path / name}"


def test_pad_batch_to_devices(rng):
    from egonn_tpu.parallel.mesh import pad_batch_to_devices as j_pad

    tree = {"clouds": rng.standard_normal((5, 4, 3)).astype(np.float32),
            "mask": rng.random((5, 4)) > 0.5, "pairs": [np.arange(5), np.arange(6).reshape(3, 2)]}
    for n in (1, 2, 3, 4, 8):
        got, want = mesh.pad_batch_to_devices(tree, n), j_pad(tree, n)
        flat = lambda t: [t["clouds"], t["mask"], *t["pairs"]]  # noqa: E731
        for a, b in zip(flat(got), flat(want)):
            assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b)), n
            assert a.shape[0] % n == 0


def test_rank_rows_without_a_group():
    assert mesh.row_slice(6, None) == slice(0, 6)
    assert mesh.world_size(None) == 1 and mesh.rank_of(None) == 0
    x = torch.arange(6.0)
    assert mesh.all_gather_rows(x, None) is x and mesh.all_reduce_sum(x, None) is x
    with pytest.raises(ValueError, match="nccl or gloo"):
        mesh.check_backend("cpu", "mpi", 2)
    with pytest.raises(ValueError, match="CUDA"):
        mesh.check_backend("cpu", "nccl", 1)


def test_dryrun_two_ranks(capsys):
    """The dry run's CLI: augmentation on, 2 gloo ranks against one process."""
    assert dryrun.main(["2", "--timeout", str(TIMEOUT_S)]) == 0
    out = capsys.readouterr().out
    assert "dryrun(2 ranks, cpu)" in out and out.rstrip().endswith("OK")


def test_padded_bucket_two_ranks(tmp_path):
    """3 real clouds in a bucket of 4 (the last row repeated by
    pad_batch_to_devices, its point mask, positives and negatives False)
    and 2 pairs: the 2-rank step equals one process on the same rows."""
    from egonn_tpu_torch.config import TrainingParams
    from egonn_tpu_torch.data.train_batch import make_train_batch

    tp = TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                        require_dataset=False)
    tp.model_params.cap0, tp.local_batch_size = CAP0, 2
    g, l = make_train_batch(tp, tp.model_params.quantizer, "cpu", n_places=2,
                            n_points=N_POINTS, seed=4)
    g = mesh.pad_batch_to_devices({k: v.numpy()[:3] for k, v in g.items()}, 2)
    g["point_mask"][3] = False
    pos = np.zeros((4, 4), bool)
    neg = np.zeros((4, 4), bool)
    pos[:3, :3] = g["positives_mask"][:3, :3]
    neg[:3, :3] = g["negatives_mask"][:3, :3]
    g.update(positives_mask=pos, negatives_mask=neg)
    l = {k: v.numpy() for k, v in l.items()}
    args = (tp, CAP0, 2, g, l, 5, 1e-3, "cpu")
    single = dryrun.rank_step(None, *args)
    ranks = mesh.run_ranks(dryrun.rank_step, 2, args, init_method=_init(tmp_path),
                           timeout_s=TIMEOUT_S)
    verdict = dryrun.compare(single, ranks)
    assert verdict["ok"], verdict
    # the third cloud lost its place's second scan: only the first place mines
    assert single["stats"]["num_triplets"] == 2.0


def _evaluate_rank(group, root, eval_file):
    """Embeddings (global and local) of the map set and RotationEvaluator's
    recalls at 0 and 90 deg, on this rank's share of each batch (batch 3:
    4 rows over 2 ranks)."""
    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.eval.evaluator import Evaluator
    from egonn_tpu_torch.eval.rotations import RotationEvaluator
    from egonn_tpu_torch.models.factory import create_egonn_model

    mp = ModelParams("model_configs/egonn.txt")
    built = create_egonn_model(mp, cap0=CAP0, device="cpu", seed=3)
    ev = Evaluator(root, "synthetic", eval_file, built, num_points=N_POINTS, batch_size=3,
                   group=group)
    emb = ev.compute_embeddings(ev.eval_set.map_set, with_local=True, n_k=64)
    rot = RotationEvaluator(root, "synthetic", eval_file, built, num_points=N_POINTS,
                            batch_size=3, thetas_deg=(0, 90), group=group).evaluate()
    return dict(batch_size=ev.batch_size, emb=emb, capacity=ev.capacity_ok,
                recall={t: {r: v.tolist() for r, v in m["recall"].items()}
                        for t, m in rot.items()},
                top1={t: m["top1_ndx"].tolist() for t, m in rot.items()})


def test_sharded_evaluation_equals_unsharded(tmp_path):
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset

    root = str(tmp_path / "synth")
    _, _, eval_file = generate_synthetic_dataset(root, n_scans=8, extent=60.0,
                                                 scan_radius=40.0, max_points=2048, seed=0)
    single = _evaluate_rank(None, root, eval_file)
    ranks = mesh.run_ranks(_evaluate_rank, 2, (root, eval_file), init_method=_init(tmp_path),
                           timeout_s=TIMEOUT_S)
    assert single["batch_size"] == 3 and ranks[0]["batch_size"] == 4
    for r in ranks:
        assert r["recall"] == single["recall"] and r["top1"] == single["top1"]
        assert r["capacity"] == ranks[0]["capacity"]
        assert set(r["emb"]) == set(single["emb"])
        for k, want in single["emb"].items():
            got = r["emb"][k]
            if want.dtype == bool:
                assert np.array_equal(got, want), k
            else:
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=k)
    for k, v in ranks[0]["emb"].items():
        assert np.array_equal(ranks[1]["emb"][k], v), k  # every rank holds every row


def _fail_on_rank1(group):
    if mesh.rank_of(group) == 1:
        raise ValueError("rank 1 broke")
    return mesh.world_size(group)


def test_a_failing_rank_raises_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 broke"):
        mesh.run_ranks(_fail_on_rank1, 2, init_method=_init(tmp_path), timeout_s=TIMEOUT_S)
    assert mesh.run_ranks(_fail_on_rank1, 1) == [1]
