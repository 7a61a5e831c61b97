"""Port vs JAX: the training entry point (`do_train`) and the host modules it
reads, on the CPU, at tests/test_resume.py's small setup (cap0 256,
num_points 512, batch 8, local batch 4) over a synthetic set written by the
JAX package's generator and read by the port through its mapping
unpickler.

* host modules, exact: the unpickler (in a subprocess that must not import
  egonn_tpu), `BatchSampler` over 3 epochs with one expansion,
  `quantize_np`, `Training6DOFDataset` items and `make_local_batch`,
  `make_global_batch` with bucket padding rows, and `Prefetcher`;
* the loop: JAX's `do_train` and the port's, one debug epoch each from
  JAX's initial variables with augmentation off: per-epoch stats within
  rel 1e-3 (marked slow: JAX compiles its init, train, validation and
  audit programs, ~90 s here);
* the port alone: resume bit-equal to the uninterrupted run, the capacity
  audit's warning, the in-training evaluation's cadence, kernel calls per
  step at two buckets, the CLI.
"""
import contextlib
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import torch_threads
import chip_smoke
from egonn_tpu.config import TrainingParams as JTrainingParams
from egonn_tpu.data import base as jbase
from egonn_tpu.data.local_dataset import Training6DOFDataset as JTraining6DOFDataset
from egonn_tpu.data.local_dataset import make_local_batch as j_make_local_batch
from egonn_tpu.data.pipeline import make_global_batch as j_make_global_batch
from egonn_tpu.data.samplers import BatchSampler as JBatchSampler
from egonn_tpu.data.synthetic import generate_synthetic_dataset as j_generate
from egonn_tpu.ops import quantization as jq
from egonn_tpu_torch.config import TrainingParams
from egonn_tpu_torch.data import base as tbase
from egonn_tpu_torch.data.local_dataset import Training6DOFDataset, make_local_batch
from egonn_tpu_torch.data.pipeline import Prefetcher, make_global_batch, round_to_bucket
from egonn_tpu_torch.data.samplers import BatchSampler
from egonn_tpu_torch.ops import quantization as tq
from egonn_tpu_torch.parallel import mesh as parallel_mesh
from egonn_tpu_torch.parallel.mesh import resolve_mesh
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.train import cli
from egonn_tpu_torch.train import trainer as ttrainer
from egonn_tpu_torch.train.state import load_checkpoint_meta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS, CAP0, BATCH, LOCAL_BATCH = 512, 256, 8, 4
BUCKETS = (8, 11, 15, 16)  # expansion_buckets(8, 16, 1.4)
STAT_REL_TOL = 1e-3
LOOP_LR = 1e-5  # test_do_train_matches_jax: see its docstring


@pytest.fixture(scope="module")
def jdata(tmp_path_factory):
    """A synthetic set written by the JAX package: (root, train, val, test)."""
    root = str(tmp_path_factory.mktemp("jsynth"))
    names = j_generate(root, n_scans=32, extent=60.0, scan_radius=40.0, max_points=2048,
                       seed=0)
    return (root, *names)


def _params(cls, jdata, epochs=1):
    """tests/test_resume.py's small training setup on `cls` (either
    package's TrainingParams)."""
    root, train_p, val_p, _ = jdata
    p = cls("config/config_egonn.txt", "model_configs/egonn.txt", require_dataset=False)
    p.dataset_folder, p.train_file, p.val_file, p.test_file = root, train_p, val_p, None
    p.batch_size, p.batch_size_limit, p.batch_expansion_rate = BATCH, 16, 1.4
    p.batch_expansion_th = 1.1  # expand after every epoch
    p.local_batch_size, p.save_freq, p.mesh, p.epochs = LOCAL_BATCH, 1, "off", epochs
    mp = p.model_params
    mp.cap0, mp.num_points, mp.num_points_explicit = CAP0, N_POINTS, True
    return p


# ---------------------------------------------------------------------------
# host modules, exact
# ---------------------------------------------------------------------------

def test_mapping_unpickler_imports_no_jax_package(jdata):
    """The port reads the JAX package's tuple pickle without importing
    egonn_tpu (a plain pickle.load would, which the subprocess also shows)."""
    root, train_p = jdata[0], jdata[1]
    code = (
        "import pickle, sys\n"
        "from egonn_tpu_torch.data.base import TrainingDataset, TrainingTuple\n"
        "from egonn_tpu_torch.data.local_dataset import Training6DOFDataset\n"
        "from egonn_tpu_torch.ops.quantization import PolarQuantizer\n"
        f"ds = Training6DOFDataset({root!r}, 'synthetic', {train_p!r}, "
        "PolarQuantizer([1.0, 0.3, 0.2]), rot_max=1.0, trans_max=2.0)\n"
        "ds.set_epoch(1)\n"
        "assert all(type(q) is TrainingTuple for q in ds.queries.values())\n"
        "assert len(ds[ds.valid_ids[0]]) == 3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'egonn_tpu')\n"
        "assert not bad, bad\n"
        f"pickle.load(open({os.path.join(root, train_p)!r}, 'rb'))\n"
        "assert 'egonn_tpu.data.base' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_mapping_unpickler_fields(jdata, tmp_path, monkeypatch):
    """Every field equal to JAX's own read; the reference's class path maps
    too, and another class of the JAX package is refused."""
    root, train_p = jdata[0], jdata[1]
    got = tbase.load_training_tuples(os.path.join(root, train_p))
    with open(os.path.join(root, train_p), "rb") as f:
        want = pickle.load(f)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is tbase.TrainingTuple
        assert (g.id, g.timestamp, g.rel_scan_filepath) == (w.id, w.timestamp,
                                                            w.rel_scan_filepath)
        for field in ("positives", "non_negatives", "pose"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
        assert list(g.positives_poses) == list(w.positives_poses)
        for j, pose in w.positives_poses.items():
            np.testing.assert_array_equal(g.positives_poses[j], pose)

    # the reference's datasets.base_datasets.TrainingTuple
    ref_mod = type(sys)("datasets.base_datasets")

    class RefTuple:
        pass

    RefTuple.__module__, RefTuple.__qualname__ = "datasets.base_datasets", "TrainingTuple"
    ref_mod.TrainingTuple = RefTuple
    monkeypatch.setitem(sys.modules, "datasets", type(sys)("datasets"))
    monkeypatch.setitem(sys.modules, "datasets.base_datasets", ref_mod)
    t = RefTuple()
    t.__dict__.update(vars(want[0]))
    path = tmp_path / "ref.pickle"
    path.write_bytes(pickle.dumps({0: t}))
    monkeypatch.delitem(sys.modules, "datasets.base_datasets")
    ref = tbase.load_training_tuples(str(path))[0]
    assert type(ref) is tbase.TrainingTuple and ref.rel_scan_filepath == want[0].rel_scan_filepath

    path.write_bytes(pickle.dumps(jbase.EvaluationTuple(1, "a.bin", np.zeros(2))))
    with pytest.raises(pickle.UnpicklingError, match="egonn_tpu.data.base.EvaluationTuple"):
        tbase.load_training_tuples(str(path))


def test_batch_sampler_matches_jax(jdata):
    """Three epochs of batches, with an expansion after the first, equal to
    JAX's for the same seed."""
    root, train_p = jdata[0], jdata[1]
    t_ds = tbase.TrainingDataset(root, "synthetic", train_p)
    j_ds = jbase.TrainingDataset(root, "synthetic", train_p)
    kw = dict(batch_size=BATCH, batch_size_limit=16, batch_expansion_rate=1.4, seed=0)
    t_s, j_s = BatchSampler(t_ds, **kw), JBatchSampler(j_ds, **kw)
    sizes = []
    for epoch in (1, 2, 3):
        t_s.set_epoch(epoch)
        j_s.set_epoch(epoch)
        got, want = list(t_s), list(j_s)
        assert got == want and len(got) > 1
        sizes.append(t_s.batch_size)
        if epoch == 1:
            t_s.expand_batch()
            j_s.expand_batch()
    assert sizes == [8, 11, 11]
    t_s.set_epoch(2)
    assert max(len(b) for b in t_s) > BATCH  # the expanded size reaches the batches


@pytest.mark.parametrize("quantizer", ["polar", "cartesian", "wide", "empty"])
def test_quantize_np_matches_jax(rng, quantizer):
    """Coordinates and kept indices equal to JAX's row-wise unique: through
    one packed int64 key per voxel, and through the row-wise fallback where
    the spans (2.2e6 voxels a side here) do not fit 63 bits."""
    pc = (rng.standard_normal((4000, 3)) * [20.0, 20.0, 2.0]).astype(np.float32)
    pc[2000:] = pc[:2000] + rng.normal(0, 0.01, (2000, 3)).astype(np.float32)  # shared voxels
    if quantizer == "polar":
        tquant, jquant = tq.PolarQuantizer([1.0, 0.3, 0.2]), jq.PolarQuantizer([1.0, 0.3, 0.2])
    else:
        step = 1.0 if quantizer == "wide" else 0.3
        tquant, jquant = tq.CartesianQuantizer(step), jq.CartesianQuantizer(step)
    if quantizer == "wide":
        pc[:4] = [[1.1e6, 0, 0], [-1.1e6, 1.1e6, 0], [0, -1.1e6, 1.1e6], [0, 0, -1.1e6]]
    if quantizer == "empty":
        pc = pc[:0]
    coords = np.floor(pc / np.float32(1.0)).astype(np.int32)
    assert tq._voxel_keys(coords).ndim == (2 if quantizer in ("wide", "empty") else 1)
    got, want = tq.quantize_np(tquant, pc), jq.quantize_np(jquant, pc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.shape == w.shape
    if quantizer != "empty":
        assert len(got[1]) < len(pc) and np.all(np.diff(got[1]) > 0)


def test_local_dataset_matches_jax(jdata):
    """Every pair of one epoch (clouds and t_gt) and one local batch equal to
    JAX's, with the configuration's rot_max and trans_max."""
    root, train_p = jdata[0], jdata[1]
    tp = TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                        require_dataset=False)
    kw = dict(rot_max=tp.rot_max, trans_max=tp.trans_max)
    t_ds = Training6DOFDataset(root, "synthetic", train_p, tq.PolarQuantizer([1.0, 0.3, 0.2]),
                               **kw)
    j_ds = JTraining6DOFDataset(root, "synthetic", train_p, jq.PolarQuantizer([1.0, 0.3, 0.2]),
                                **kw)
    assert t_ds.valid_ids == j_ds.valid_ids and len(t_ds.valid_ids) > LOCAL_BATCH
    t_ds.set_epoch(1)
    j_ds.set_epoch(1)
    for ndx in t_ds.valid_ids:
        for g, w in zip(t_ds[ndx], j_ds[ndx]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    ids = t_ds.valid_ids[:LOCAL_BATCH]
    got, want = make_local_batch(t_ds, ids, N_POINTS), j_make_local_batch(j_ds, ids, N_POINTS)
    for field in ("anc_clouds", "anc_mask", "pos_clouds", "pos_mask", "t_gt"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert not np.array_equal(t_ds[ids[0]][2], t_ds.queries[ids[0]].positives_poses[
        int(t_ds.get_positives(ids[0])[0])])  # the random transform was composed


def test_make_global_batch_matches_jax(jdata):
    """A full bucket and one with padding rows: clouds, masks, positives,
    negatives and valid rows equal to JAX's; padding rows empty."""
    root, train_p = jdata[0], jdata[1]
    t_ds = tbase.TrainingDataset(root, "synthetic", train_p)
    j_ds = jbase.TrainingDataset(root, "synthetic", train_p)
    sampler = BatchSampler(t_ds, batch_size=BATCH, seed=0)
    sampler.set_epoch(1)
    first, second = list(sampler)[:2]
    for ids, rows in ((first, 8), (first[:6], 8), (first + second[:2], 11)):
        got = make_global_batch(t_ds, ids, N_POINTS, BUCKETS)
        want = j_make_global_batch(j_ds, ids, N_POINTS, BUCKETS)
        for field in ("clouds", "point_mask", "positives_mask", "negatives_mask",
                      "valid_elems"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert got.clouds.shape == (rows, N_POINTS, 3)
        pad = ~got.valid_elems
        assert pad.sum() == rows - len(ids)
        assert not got.point_mask[pad].any() and not got.clouds[pad].any()
        assert not got.positives_mask[pad].any() and not got.positives_mask[:, pad].any()
        assert not got.negatives_mask[pad].any() and not got.negatives_mask[:, pad].any()
        assert got.positives_mask[~pad].any() and got.negatives_mask[~pad].any()


def test_round_to_bucket():
    assert [round_to_bucket(b, BUCKETS) for b in (1, 8, 9, 11, 12, 16, 40)] == \
        [8, 8, 11, 11, 15, 16, 16]


def test_prefetcher_keeps_order():
    assert list(Prefetcher(lambda: iter(range(100)), depth=2)) == list(range(100))


def test_prefetcher_reraises_a_workers_error():
    """The JAX package's Prefetcher ends the epoch at a loading error
    (ROADMAP C, known difference); the port raises it after the items
    before it."""
    def gen():
        yield from range(5)
        raise OSError("scan 5 unreadable")

    got = []
    with pytest.raises(OSError, match="scan 5 unreadable"):
        for item in Prefetcher(gen):
            got.append(item)
    assert got == list(range(5))


def test_prefetcher_stops_its_thread_when_left_early():
    started = threading.active_count()
    p = Prefetcher(lambda: iter(range(10**9)), depth=2)
    for i in p:
        if i == 3:
            break
    assert not p._thread.is_alive() and threading.active_count() == started


def test_step_generator_and_mesh():
    a = ttrainer.step_generator(torch.device("cpu"), 0, 3, 0, 5)
    b = ttrainer.step_generator(torch.device("cpu"), 0, 3, 0, 5)
    c = ttrainer.step_generator(torch.device("cpu"), 0, 3, 0, 6)
    x = torch.rand(4, generator=a)
    assert torch.equal(x, torch.rand(4, generator=b))
    assert not torch.equal(x, torch.rand(4, generator=c))
    cpu = torch.device("cpu")
    for one in ("auto", "off", 0, "0", 1, "1", None):
        assert resolve_mesh(one, cpu) == 1, one  # "auto" on the CPU: one process
    assert resolve_mesh(4, cpu) == resolve_mesh("4", cpu) == 4
    assert resolve_mesh("auto", "cuda") == max(1, torch.cuda.device_count())
    with pytest.raises(ValueError):
        resolve_mesh(-2, cpu)


# ---------------------------------------------------------------------------
# the loop against JAX
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_do_train_matches_jax(jdata, tmp_path, monkeypatch):
    """One debug epoch (2 train steps, 1 validation step) of each loop from
    JAX's model.init(PRNGKey(0)) variables, augmentation off on both sides:
    every per-epoch stat within rel 1e-3.  The first steps agree within
    2e-6; Adam's first update moves every weight by ~+-lr whatever its
    gradient's size, so a near-zero gradient whose sign the two stacks'
    f32 sums disagree on moves a weight by 2 lr (ROADMAP C, known
    difference 10).  At the configuration's lr 1e-3 that moves single pair
    distances of the next steps by up to 5e-3 relative; both loops run at
    lr 1e-5, where it is 8e-5, so that rel 1e-3 tests the loop (batches,
    skips, the stats' means, BatchNorm statistics carried between steps and
    phases).  Slow: JAX compiles four programs (~90 s here)."""
    from egonn_tpu.train import trainer as jtrainer
    from egonn_tpu_torch.models import factory as tfactory
    from egonn_tpu_torch.utils.weights import load_flax_variables

    init = {}
    j_init_state = jtrainer.init_train_state

    def capture_init(variables, tx):
        init["variables"] = variables
        return j_init_state(variables, tx)

    j_pre = jtrainer.device_preprocess_global
    monkeypatch.setattr(jtrainer, "init_train_state", capture_init)
    monkeypatch.setattr(jtrainer, "device_preprocess_global",
                        lambda *a, rng_key=None, **k: j_pre(*a, rng_key=None, **k))
    j_params, t_params = _params(JTrainingParams, jdata), _params(TrainingParams, jdata)
    j_params.lr = t_params.lr = LOOP_LR
    _, j_stats, _ = jtrainer.do_train(j_params, debug=True,
                                      weights_path=str(tmp_path / "j"), log_fn=lambda m: None,
                                      dataset_type="synthetic")

    def factory_with_jax_init(model_params, device):
        built = tfactory.model_factory(model_params, device=device)
        load_flax_variables(built.model, init["variables"])
        return built

    t_pre = ttrainer.device_preprocess_global
    monkeypatch.setattr(ttrainer, "model_factory", factory_with_jax_init)
    monkeypatch.setattr(ttrainer, "device_preprocess_global",
                        lambda *a, gen=None, **k: t_pre(*a, gen=None, **k))
    _, t_stats, _ = ttrainer.do_train(t_params, debug=True,
                                      weights_path=str(tmp_path / "t"), log_fn=lambda m: None,
                                      dataset_type="synthetic", device="cpu")
    for phase in ("train", "val"):
        assert len(t_stats[phase]) == len(j_stats[phase]) == 1
        got, want = t_stats[phase][0], j_stats[phase][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=STAT_REL_TOL, atol=1e-6,
                                       err_msg=f"{phase} {k}")


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _state_tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    return out


@pytest.fixture(scope="module")
def two_epochs(jdata, tmp_path_factory):
    """Two debug epochs of the port's loop (2 train steps and 1 validation
    step each, an expansion after each, cap0 256 below the scans' ~500
    occupied voxels), the second captured under EGONN_TRACE_DIR: the final
    state, the run's directory and model name, its stdout, each step's
    (global rows, train, kernel calls) and the trace directory."""
    counts = []
    step_call = ttrainer.TrainStep.__call__

    def counted(self, g, l, gen, lr, train):
        out = []
        calls = chip_smoke.record_calls(kernels, lambda: out.append(step_call(self, g, l, gen, lr,
                                                                              train)))
        counts.append((g["clouds"].shape[0], train,
                       {n: sum(chip_smoke.row_of(c[0]) == n for c in calls)
                        for n in chip_smoke.TRAIN_STEP_LAUNCHES}))
        return out[0]

    weights = tmp_path_factory.mktemp("two_epochs")
    traces = tmp_path_factory.mktemp("two_epochs_traces")
    stdout = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(stdout):
        mp.setenv("EGONN_TRACE_DIR", str(traces))
        mp.delenv("EGONN_TRACE_EPOCH", raising=False)
        mp.setattr(ttrainer.TrainStep, "__call__", counted)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        state, _, name = ttrainer.do_train(_params(TrainingParams, jdata, epochs=2), debug=True,
                                           weights_path=str(weights), log_fn=lambda m: None,
                                           dataset_type="synthetic", device="cpu")
    return dict(state=state, run=weights / name, out=stdout.getvalue(), counts=counts,
                traces=traces)


def test_resume_matches_uninterrupted(jdata, two_epochs, tmp_path):
    """Two epochs against a resume from a copy of their epoch-1 checkpoint in
    a fresh directory, with an expansion after every epoch: parameters,
    BatchNorm statistics, the optimizer's state and the sampler's batch
    size bit-equal (tests/test_resume.py's contract)."""
    ckpt = tmp_path / two_epochs["run"].name
    ckpt.mkdir()
    for f in ("step_1.pt", "step_1.meta.json"):
        shutil.copy(two_epochs["run"] / f, ckpt / f)
    assert load_checkpoint_meta(str(ckpt), 1) == {"sampler_batch_size": 11}
    res, _, _ = ttrainer.do_train(_params(TrainingParams, jdata, epochs=2), debug=True,
                                  resume_from=str(ckpt), log_fn=lambda m: None,
                                  dataset_type="synthetic", device="cpu")
    full = two_epochs["state"]
    assert res.epoch == full.epoch == 2
    assert sorted(os.listdir(ckpt)) == ["step_1.meta.json", "step_1.pt", "step_2.meta.json",
                                        "step_2.pt"]
    assert load_checkpoint_meta(str(ckpt), 2) == {"sampler_batch_size": 15}
    a, b = _state_tensors(full), _state_tensors(res)
    assert a.keys() == b.keys() and any(k.startswith("adam.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_do_train_on_mesh_of_two(jdata, tmp_path, capfd, monkeypatch):
    """`do_train` with mesh 2 on the CPU (two gloo ranks; the counterpart of
    JAX's test_do_train_on_mesh_smoke): two debug epochs without batch
    expansion at lr 1e-5 (see test_do_train_matches_jax); the first epoch's
    stats within rel 1e-4 of one process's.  Rank 0 alone prints, writes
    the metrics JSONL and the checkpoints; a resume from a copy of the
    epoch-1 checkpoint on 2 ranks ends bit-equal to the uninterrupted
    2-rank run."""
    def params(mesh, epochs=2):
        p = _params(TrainingParams, jdata, epochs=epochs)
        p.mesh, p.lr, p.batch_expansion_th = mesh, LOOP_LR, None
        return p

    monkeypatch.setattr(parallel_mesh, "DEFAULT_TIMEOUT_S", 120.0)  # a hung rank fails

    _, one, _ = ttrainer.do_train(params("off", epochs=1), debug=True,
                                  weights_path=str(tmp_path / "one"), log_fn=lambda m: None,
                                  dataset_type="synthetic", device="cpu")
    capfd.readouterr()
    weights = tmp_path / "two"
    with torch_threads.shared_by(2):
        state, two, name = ttrainer.do_train(params(2), debug=True, weights_path=str(weights),
                                             dataset_type="synthetic", device="cpu")
    out = capfd.readouterr().out
    for phase in ("train", "val"):
        assert len(two[phase]) == 2 and len(one[phase]) == 1
        got, want = two[phase][0], one[phase][0]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{phase} {k}")
    assert out.count("epoch 1 took") == out.count("epoch 2 took") == 1
    assert "Data-parallel mesh over 2 ranks" in out
    assert sorted(os.listdir(weights / name)) == ["step_1.meta.json", "step_1.pt",
                                                  "step_2.meta.json", "step_2.pt"]
    lines = [json.loads(s) for s in (weights / f"{name}.metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines if "train" in r] == [1, 2]
    ckpt = tmp_path / "resumed" / name
    ckpt.mkdir(parents=True)
    for f in ("step_1.pt", "step_1.meta.json"):
        shutil.copy(weights / name / f, ckpt / f)
    with torch_threads.shared_by(2):
        res, _, _ = ttrainer.do_train(params(2), debug=True, resume_from=str(ckpt),
                                      log_fn=lambda m: None, dataset_type="synthetic",
                                      device="cpu")
    a, b = _state_tensors(state), _state_tensors(res)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_do_train_capture_holds_the_step_spans(two_epochs):
    """EGONN_TRACE_DIR captures the second epoch (EGONN_TRACE_EPOCH's
    default) alone: each of its 2 train steps and 1 validation step is one
    egonn.train_step span with its forwards, losses and, in training, its
    backward and optimizer spans."""
    assert sorted(p.name for p in two_epochs["traces"].iterdir()) == ["train_epoch2"]
    events = json.loads((two_epochs["traces"] / "train_epoch2" / "trace.json").read_text())
    names = [e["name"] for e in events["traceEvents"] if e.get("cat") == "user_annotation"]
    assert names.count("egonn.train_step") == 3
    assert names.count("egonn.step.forward") == 9 and names.count("egonn.step.loss") == 6
    assert names.count("egonn.step.backward") == names.count("egonn.step.optimizer") == 2


def test_capacity_audit_warns_within_one_epoch(two_epochs):
    """A capacity below the scans' occupancy warns in the first epoch."""
    first_epoch = two_epochs["out"].split("epoch 1 took")[0]
    assert "voxel-capacity overflow (cap_L0" in first_epoch


def test_in_training_evaluation_cadence(jdata, tmp_path, monkeypatch, capsys):
    """With the cadence patched to 1: one evaluator built, run after each of
    2 epochs in eval mode, its recall logged; the model's mode restored.  A
    failing evaluation is printed and training goes on."""
    from egonn_tpu_torch.eval import evaluator as tev

    built, runs = [], []

    class Spy(tev.GLEvaluator):
        def __init__(self, *a, **k):
            built.append(k)
            super().__init__(*a, **k)

        def evaluate(self):
            runs.append(self.built.model.training)
            if len(runs) == 2:
                raise RuntimeError("evaluation broke")
            return super().evaluate()

    monkeypatch.setattr(tev, "GLEvaluator", Spy)
    monkeypatch.setattr(ttrainer, "EVAL_EVERY", 1)
    params = _params(TrainingParams, jdata, epochs=2)
    params.val_file, params.test_file = None, jdata[3]
    records = []
    state, stats, _ = ttrainer.do_train(params, debug=True, weights_path=str(tmp_path),
                                        log_fn=records.append, dataset_type="synthetic",
                                        device="cpu")
    assert runs == [False, False] and len(built) == 1
    assert built[0]["k"] == 20 and built[0]["n_samples"] == 100 and built[0]["n_k"] == (128,)
    assert not state.model.training and len(stats["train"]) == 2
    tests = [r for r in records if "test" in r]
    assert [r["epoch"] for r in tests] == [1] and set(tests[0]["test"]["recall@1"]) == {5, 20}
    assert [r["epoch"] for r in records if "train" in r] == [1, 2]
    out = capsys.readouterr().out
    assert "Recall@N" in out and "in-training eval failed: RuntimeError('evaluation broke')" in out


def test_kernel_calls_per_step_at_two_buckets(two_epochs):
    """Each loop step makes the kernel calls chip_smoke.py asserts on the
    card (TRAIN_STEP_LAUNCHES, VAL_STEP_LAUNCHES; but `slot_order`, which a
    CPU level does not build), at bucket 8 and, after an expansion, at
    larger ones: the batch changes no level count."""
    counts = two_epochs["counts"]
    buckets = sorted({b for b, train, _ in counts if train})
    assert len(buckets) > 1 and buckets[0] == 8 and set(buckets) <= set(BUCKETS)
    assert {train for _, train, _ in counts} == {True, False}
    for _, train, c in counts:
        want = chip_smoke.TRAIN_STEP_LAUNCHES if train else chip_smoke.VAL_STEP_LAUNCHES
        assert c == dict(want, slot_order=0)


def _write_configs(tmp_path, root, names):
    cfg = tmp_path / "config.txt"
    cfg.write_text(f"[DEFAULT]\ndataset = synthetic\ndataset_folder = {root}\n\n[TRAIN]\n"
                   f"batch_size = {BATCH}\nlocal_batch_size = {LOCAL_BATCH}\nlr = 1e-3\n"
                   "epochs = 5\nscheduler_milestones = 3\naug_mode = 2\nweight_decay = 1e-4\n"
                   "loss = BatchHardTripletMarginLoss\nl_gammas = 1., 1., 1., 4.\n"
                   f"margin = 0.2\ntrain_file = {names[0]}\n")
    model_cfg = tmp_path / "model.txt"
    model_cfg.write_text("[MODEL]\nmodel = egonn\ncoordinates = polar\n"
                         "quantization_step = 1., 0.3, 0.2\n\n[TPU]\n"
                         f"num_points = {N_POINTS}\ncap0 = {CAP0}\n")
    return str(cfg), str(model_cfg)


def test_train_cli(jdata, tmp_path, monkeypatch, capsys):
    """One debug epoch on the CPU writes a checkpoint and the metrics JSONL;
    without a card and without --device cpu the CLI stops."""
    cfg, model_cfg = _write_configs(tmp_path, jdata[0], jdata[1:2])
    weights = tmp_path / "weights"
    args = ["--config", cfg, "--model_config", model_cfg, "--weights_path", str(weights),
            "--epochs", "1", "--debug"]
    try:
        cli.main(args + ["--device", "cpu"])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    (run,) = [d for d in os.listdir(weights) if os.path.isdir(weights / d)]
    assert sorted(os.listdir(weights / run)) == ["step_1.meta.json", "step_1.pt"]
    lines = [json.loads(s) for s in (weights / f"{run}.metrics.jsonl").read_text().splitlines()]
    assert "_config" in lines[0]
    (epoch,) = [r for r in lines if "train" in r]
    assert epoch["epoch"] == 1 and epoch["steps"] == {"train": 2}
    assert set(epoch["seconds"]) == {"train"} and np.isfinite(epoch["train"]["loss"])
    assert "Debug mode: True" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(args)
