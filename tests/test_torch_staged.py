"""MinkLoc3Dv2 trained as published: the Truncated Smooth AP loss
(`losses/smoothap.py`), the staged step (`train/trainer.py::
StagedTrainStep`), its configuration keys, capacity table and augmentation
amplitudes, and `do_train` on global batches alone; held against the
benchmark's plain reference (`benchmark/reference/smoothap.py`,
`staged.py`) and against one-shot autograd, at a small size on the CPU
with the published widths."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.core import compare, scans, submaps, weights
from benchmark.reference import models as ref_models
from benchmark.reference import smoothap as ref_smoothap
from benchmark.reference import sparse as ref_sparse
from benchmark.reference import staged as ref_staged
from benchmark.reference import train as ref_train
from egonn_tpu_torch import config as tconfig
from egonn_tpu_torch.data import augmentation as taug
from egonn_tpu_torch.data.pipeline import device_preprocess_global
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.losses.smoothap import truncated_smooth_ap
from egonn_tpu_torch.models.factory import create_egonn_model, model_factory
from egonn_tpu_torch.train.trainer import StagedTrainStep, TrainStep, make_train_step

CONFIG, MODEL_CONFIG = "config/config_minkloc3dv2.txt", "model_configs/minkloc3dv2.txt"
N_POINTS, CAPACITY, PLACES, SPLIT, LR = 256, 256, 2, 4, 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: these tests run many small ops,
    which under a loaded machine's oversubscription wait on their thread
    pool far longer than they compute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(split: int = SPLIT, similarity: str = "euclidean"):
    tp = tconfig.TrainingParams(CONFIG, MODEL_CONFIG, require_dataset=False)
    tp.batch_split_size, tp.similarity = split, similarity
    tp.model_params.capacities = [CAPACITY] * 5
    return tp


def _weighted(tp, seed: int = 3):
    """The program's model and the reference's on one seeded state."""
    cfg = json.load(open("benchmark/configs/minkloc3dv2_oxford.json"))
    cfg["model"]["capacities"] = [CAPACITY] * 5
    cfg["train"].update(batch_split_size=tp.batch_split_size, similarity=tp.similarity)
    ref = ref_models.MinkLoc(cfg)
    state = weights.seeded_state({k: v.shape for k, v in ref.state_dict().items()},
                                 ref_models.param_kinds(ref), seed, "cpu")
    ref.load_state_dict(state)
    built = model_factory(tp.model_params, device="cpu")
    built.model.load_state_dict(state)
    return built, ref, cfg, state


def _batch(seed: int = 1):
    return submaps.make_batch(scans.generator("cpu", seed, 4), PLACES, 4, N_POINTS)


# ---------------------------------------------------------------------------
# configuration, capacities, augmentation
# ---------------------------------------------------------------------------

def test_minkloc3dv2_config_parses():
    tp = tconfig.TrainingParams(CONFIG, MODEL_CONFIG, require_dataset=False)
    assert (tp.batch_size, tp.batch_split_size, tp.lr, tp.weight_decay) == (2048, 128, 1e-3, 1e-4)
    assert (tp.loss, tp.tau1, tp.positives_per_query, tp.similarity) == (
        "TruncatedSmoothAP", 0.01, 4, "euclidean")
    assert (tp.aug_mode, tp.dataset) == (1, "oxford")
    mp = tp.model_params
    assert (mp.model, mp.planes, mp.layers, mp.num_top_down, mp.conv0_kernel_size) == (
        "MinkLoc", [64, 128, 64, 32], [1, 1, 1, 1], 2, 5)
    assert (mp.block, mp.pooling, mp.feature_size, mp.output_dim) == (
        "ECABasicBlock", "GeM", 256, 256)
    assert mp.quantization_step == 0.01 and mp.capacities == [4096, 3328, 2048, 896, 384]
    # the keys the JAX package does not know are absent from other configs
    other = tconfig.TrainingParams("config/config_egonn.txt", "model_configs/minkloc3d_mulran.txt",
                                   require_dataset=False)
    for key in ("batch_split_size", "tau1", "similarity"):
        assert not hasattr(other, key)
    assert not hasattr(other.model_params, "capacities")


@pytest.mark.parametrize("line,section,error", [
    ("similarity = dot", "TRAIN", NotImplementedError),
    ("positives_per_query = 0", "TRAIN", ValueError),
    ("set_aug_mode = 2", "TRAIN", NotImplementedError),
    ("batch_split_size = 0", "TRAIN", ValueError),
    ("tau1 = 0", "TRAIN", ValueError),
    ("normalize_embeddings = True", "MODEL", NotImplementedError),
    ("capacities = 4096,2048", "TPU", ValueError),
])
def test_config_refuses_unknown_values(tmp_path, line, section, error):
    src = CONFIG if section == "TRAIN" else MODEL_CONFIG
    key = line.split(" =")[0]
    lines = open(src).read().splitlines()
    if any(x.startswith(key + " =") for x in lines):
        lines = [line if x.startswith(key + " =") else x for x in lines]
    else:
        lines.insert(lines.index(f"[{section}]") + 1, line)
    text = "\n".join(lines) + "\n"
    path = tmp_path / "cfg.txt"
    path.write_text(text)
    args = (str(path), MODEL_CONFIG) if section == "TRAIN" else (CONFIG, str(path))
    with pytest.raises(error):
        tconfig.TrainingParams(*args, require_dataset=False)


def test_capacity_table_on_egonn_refused(tmp_path):
    path = tmp_path / "egonn.txt"
    path.write_text(open("model_configs/egonn.txt").read().replace("[TPU]\n",
                                                                   "[TPU]\ncapacities = 1,2\n"))
    with pytest.raises(ValueError, match="MinkLoc"):
        tconfig.ModelParams(str(path))


def test_factory_takes_the_capacity_table():
    tp = _params()
    tp.model_params.capacities = [512, 384, 256, 256, 256]
    assert model_factory(tp.model_params, device="cpu").pyramid_spec.capacities == (
        512, 384, 256, 256, 256)
    mulran = tconfig.ModelParams("model_configs/minkloc3d_mulran.txt")
    assert model_factory(mulran, cap0=40960, device="cpu").pyramid_spec.capacities == (
        40960, 20480, 10240, 5120)


def test_normalized_amplitudes():
    """aug_mode 1 on Oxford's normalized submaps: jitter 0.001 clipped at
    0.002, translation 0.01 * N(0, 1); every other dataset's metric
    amplitudes are unchanged."""
    gen = torch.Generator().manual_seed(0)
    d = taug.draw_train_transform(gen, 2, 64, aug_mode=1)
    d.update(remove_r=torch.zeros(2), block_apply=torch.ones(2))
    pc = torch.zeros(2, 64, 3)
    mask = torch.ones(2, 64, dtype=torch.bool)
    got = taug.train_transform(pc, mask, d, 1, "oxford")
    want = torch.clamp(0.001 * d["noise"], -0.002, 0.002) + 0.01 * d["translation"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    metric = taug.train_transform(pc, mask, d, 1)
    torch.testing.assert_close(metric, torch.clamp(0.1 * d["noise"], -0.2, 0.2)
                               + 0.3 * d["translation"], rtol=0, atol=0)
    torch.testing.assert_close(taug.train_transform(pc, mask, d, 1, "mulran"), metric,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _loss_inputs(seed: int = 0):
    """12 embeddings; queries with 0, 1, 3 and 5 positives (k = 4), and
    negatives everywhere else but the diagonal."""
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn(12, 16, generator=g) * 0.05
    pos = torch.zeros(12, 12, dtype=torch.bool)
    groups = [[1, 2], [3, 4, 5, 6], [7, 8, 9, 10, 11, 0]]
    for grp in groups:
        for a in grp:
            for b in grp:
                pos[a, b] = a != b
    pos[1, 2] = pos[2, 1] = False   # 1 and 2: no positive
    pos[1, 3] = pos[3, 1] = True    # 1: one positive
    neg = ~pos & ~torch.eye(12, dtype=torch.bool)
    neg[0, 5] = neg[5, 0] = False   # neither positive nor negative
    return emb, pos, neg


@pytest.mark.parametrize("similarity", ["euclidean", "cosine"])
def test_smoothap_matches_reference(similarity):
    emb, pos, neg = _loss_inputs()
    assert sorted(set(pos.sum(1).tolist())) == [0, 1, 3, 4, 5]
    a = emb.clone().requires_grad_(True)
    b = emb.clone().requires_grad_(True)
    tau = 0.01 if similarity == "euclidean" else 1e-3
    got, stats = truncated_smooth_ap(a, pos, neg, tau, 4, similarity)
    want, ref_stats = ref_smoothap.truncated_smooth_ap(b, pos, neg, tau, 4, similarity)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    assert 0.0 < float(got.detach()) < 1.0
    for k, v in ref_stats.items():
        torch.testing.assert_close(stats[k], v)
    got.backward()
    want.backward()
    assert a.grad.abs().max() > 0
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("similarity", ["euclidean", "cosine"])
def test_smoothap_ignores_which_invalid_picks(similarity):
    """A query with fewer than k positives picks non-positives, whose order
    among the -inf entries topk breaks by position: the loss and gradient do
    not depend on them (the rows permuted pick other ones)."""
    emb, pos, neg = _loss_inputs(1)
    perm = torch.tensor([11, 3, 0, 7, 1, 9, 2, 10, 4, 8, 6, 5])
    a = emb.clone().requires_grad_(True)
    b = emb[perm].clone().requires_grad_(True)
    want, _ = truncated_smooth_ap(a, pos, neg, 0.01, 4, similarity)
    got, _ = truncated_smooth_ap(b, pos[perm][:, perm], neg[perm][:, perm], 0.01, 4, similarity)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    want.backward()
    got.backward()
    torch.testing.assert_close(b.grad, a.grad[perm], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the staged step
# ---------------------------------------------------------------------------

def _grads_of_step(step, g, gen):
    """The parameter gradients the staged step hands its optimizer."""
    taken = {}
    opt = step.state.optimizer

    def capture(closure=None):
        for n, p in step.state.model.named_parameters():
            taken[n] = p.grad.clone()

    opt.step = capture
    stats = step(g, None, gen, LR, True)
    del opt.step
    return taken, stats


def test_staged_gradient_equals_one_shot():
    """Stages 1-3 give the gradient of one-shot autograd through the same
    chunks (train-mode BatchNorm per chunk) on the same augmented clouds."""
    tp = _params()
    built, _, _, state = _weighted(tp)
    step = make_train_step(built, tp)
    assert isinstance(step, StagedTrainStep)
    g = _batch()
    staged, stats = _grads_of_step(step, g, scans.generator("cpu", 7))

    built.model.load_state_dict(state)
    built.model.train()
    clouds = ref_staged.augment(g["clouds"], g["point_mask"], ref_staged.draw_augmentation(
        scans.generator("cpu", 7), *g["clouds"].shape[:2]))
    emb = []
    for at in range(0, clouds.shape[0], SPLIT):
        pyr = device_preprocess_global(clouds[at:at + SPLIT], g["point_mask"][at:at + SPLIT],
                                       built.quantizer, built.pyramid_spec, with_kmap_down=True)
        emb.append(built.model(pyr, built.quantizer)["global"])
    loss, _ = truncated_smooth_ap(torch.cat(emb), g["positives_mask"], g["negatives_mask"],
                                  tp.tau1, tp.positives_per_query, tp.similarity)
    built.model.zero_grad(set_to_none=True)
    loss.backward()
    torch.testing.assert_close(stats["loss"], loss.detach(), rtol=1e-6, atol=1e-7)
    for n, p in built.model.named_parameters():
        scale = float(p.grad.abs().max()) + 1e-12
        assert float((staged[n] - p.grad).abs().max()) <= 1e-4 * scale, n
    assert max(float(v.abs().max()) for v in staged.values()) > 0


def test_stages_see_the_same_clouds():
    """Stage 3's forward of each chunk equals stage 1's: same augmented
    clouds, same chunks, so the same BatchNorm statistics."""
    tp = _params()
    built, _, _, _ = _weighted(tp)
    step = make_train_step(built, tp)
    g = _batch()
    chunks = g["clouds"].shape[0] // SPLIT
    outs = []
    built.model.register_forward_hook(lambda m, i, o: outs.append(o["global"].detach()))
    step(g, None, scans.generator("cpu", 7), LR, True)
    assert chunks == 2 and len(outs) == 2 * chunks
    for first, again in zip(outs[:chunks], outs[chunks:]):
        assert torch.equal(first, again)
    assert torch.equal(torch.cat(outs[:chunks]), step.embeddings)


@pytest.mark.parametrize("similarity", ["euclidean", "cosine"])
def test_three_staged_steps_match_reference(similarity):
    """Three steps against the published step in plain PyTorch: losses, the
    first gradient as Adam took it, the parameters and the BatchNorm
    statistics (advanced twice a chunk) after them."""
    tp = _params(similarity=similarity)
    built, ref, cfg, state = _weighted(tp)
    step = make_train_step(built, tp)
    adam = ref_train.Adam(dict(ref.named_parameters()), tp.lr, tp.weight_decay)
    quantizer = ref_sparse.CartesianQuantizer(cfg["model"]["quantization_step"])
    spec = ref_staged.reference_spec(cfg["model"]["capacities"], 5)
    for i in range(3):
        g = _batch(10 + i)
        stats = step(g, None, scans.generator("cpu", 20 + i), LR, True)
        loss, taken, emb, ref_stats = ref_staged.staged_step(
            ref, quantizer, spec, adam, g, scans.generator("cpu", 20 + i), cfg["train"], [])
        gap = (step.embeddings - emb).abs().amax(1) / emb.abs().amax(1)
        assert float(gap.max()) < 1e-4
        assert abs(float(stats["loss"]) - float(loss)) <= 1e-4 * abs(float(loss))
        for k in ("positives_per_query", "best_positive_ranking", "recall@1"):
            assert float(stats[k]) == float(ref_stats[k])
        if i == 0:
            opt = step.state.optimizer
            grad1 = {n: opt.state[q]["exp_avg"] / 0.1 for n, q in built.model.named_parameters()}
            gaps = compare.leaf_gaps(grad1, taken, taken)
            assert max(gaps.values()) < 1e-4, max(gaps, key=gaps.get)
    after, ref_after = built.model.state_dict(), ref.state_dict()
    moved = [k for k in after if not torch.equal(ref_after[k], state[k])]
    assert any(k.endswith(".mean") for k in moved) and any(k.endswith(".kernel") for k in moved)
    change = compare.leaf_gaps({k: after[k] - state[k] for k in moved},
                               {k: ref_after[k] - state[k] for k in moved}, moved)
    assert max(change.values()) < 1e-3, max(change, key=change.get)


def test_running_statistics_advance_twice_a_chunk():
    """Every BatchNorm's running mean moves once in each stage for each
    chunk: at lr 0, on two equal chunks without augmentation, a step moves
    it 1 - 0.9^4 of the way to the batch mean that one forward reads."""
    tp = _params()
    built, _, _, state = _weighted(tp)
    g = _batch()
    g["clouds"] = g["clouds"][:SPLIT].repeat(2, 1, 1)
    means = [k for k in state if k.endswith(".mean")]
    built.model.train()
    with torch.no_grad():
        pyr = device_preprocess_global(g["clouds"][:SPLIT], g["point_mask"][:SPLIT],
                                       built.quantizer, built.pyramid_spec, with_kmap_down=True)
        built.model(pyr, built.quantizer)
    once = {k: built.model.state_dict()[k].clone() for k in means}
    built.model.load_state_dict(state)
    make_train_step(built, tp)(g, None, None, 0.0, True)
    for k in means:
        batch_mean = (once[k] - 0.9 * state[k]) / 0.1
        want = 0.9 ** 4 * state[k] + (1 - 0.9 ** 4) * batch_mean
        torch.testing.assert_close(built.model.state_dict()[k], want, rtol=1e-4, atol=1e-5)


def test_validation_changes_nothing():
    tp = _params()
    built, _, _, _ = _weighted(tp)
    step = make_train_step(built, tp)
    g = _batch()
    step(g, None, scans.generator("cpu", 1), LR, True)
    before = {k: v.clone() for k, v in built.model.state_dict().items()}
    a = step(g, None, None, LR, False)
    b = step(g, None, scans.generator("cpu", 2), LR, False)
    assert all(torch.equal(v, built.model.state_dict()[k]) for k, v in before.items())
    assert all(torch.equal(a[k], b[k]) for k in a) and not built.model.training


def test_make_train_step_dispatch():
    tp = _params()
    built = model_factory(tp.model_params, device="cpu")
    assert isinstance(make_train_step(built, tp), StagedTrainStep)
    del tp.batch_split_size
    with pytest.raises(NotImplementedError, match="batch_split_size"):
        make_train_step(built, tp)
    egonn = tconfig.TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                                   require_dataset=False)
    assert type(make_train_step(create_egonn_model(egonn.model_params, cap0=512, device="cpu"),
                                egonn)) is TrainStep


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_egonn_train_step_unchanged():
    """EgoNN's step dispatches the operations, and gives the losses, that it
    did before the staged step was added (recorded with PyTorch 2.13 on the
    CPU at this size, on one thread)."""
    torch.manual_seed(0)
    tp = tconfig.TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                                require_dataset=False)
    step = make_train_step(create_egonn_model(tp.model_params, cap0=512, device="cpu"), tp)
    clouds = torch.from_numpy(lidar_scan_clouds(4, 1024, seed=0) * 0.3)
    ones = torch.ones(clouds.shape[:2], dtype=torch.bool)
    glob = clouds[:2].repeat_interleave(2, 0)
    glob[1::2] += torch.tensor([0.3, -0.2, 0.0])
    labels = torch.arange(4) // 2
    g = dict(clouds=glob, point_mask=ones[:4],
             positives_mask=(labels[:, None] == labels[None]) & ~torch.eye(4, dtype=torch.bool),
             negatives_mask=labels[:, None] != labels[None])
    anc = clouds[2:]
    l = dict(anc_clouds=anc, anc_mask=ones[:2], pos_clouds=anc.clone(), pos_mask=ones[:2],
             t_gt=torch.from_numpy(np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))))
    want = {True: (52527, 0.9051886200904846, 0.25013411045074463, 0.65505450963974),
            False: (19948, 5.450882434844971, 0.18914125859737396, 5.2617411613464355)}
    for train, (n_ops, loss, global_loss, local_loss) in want.items():
        with _Ops() as ops:
            stats = step(g, l, torch.Generator().manual_seed(0) if train else None, LR, train)
        assert ops.n == n_ops, train
        got = [float(stats[k]) for k in ("loss", "global_loss", "local_loss")]
        np.testing.assert_allclose(got, [loss, global_loss, local_loss], rtol=1e-6)


# ---------------------------------------------------------------------------
# spans, do_train
# ---------------------------------------------------------------------------

def test_staged_step_spans(tmp_path):
    """A staged train step is one egonn.train_step: egonn.step.embed (the
    augmentation, then each chunk's quantize, pyramid, trunk and head),
    egonn.step.loss, a forward (trunk and head) and a backward a chunk,
    and the optimizer; validation the embed and the loss alone.  Each
    transposed conv is an egonn.tconv inside the phase that runs it: a
    forward's two top-down steps, a backward's four down convs' dX."""
    from test_torch_tracing import _inside, _phases, _spans, _tconvs_inside

    tp = _params()
    built, _, _, _ = _weighted(tp)
    step = make_train_step(built, tp)
    g = _batch()
    chunks = g["clouds"].shape[0] // SPLIT
    model = ["egonn.trunk", "egonn.global_head"]
    for train in (True, False):
        gen = scans.generator("cpu", 1) if train else None
        spans = _spans(lambda: step(g, None, gen, LR, train), tmp_path / f"{train}.json")
        (top,) = [s for s in spans if s[0] == "egonn.train_step"]
        inner = _inside(spans, top)
        assert len(inner) + 1 == len(spans)
        phases = [s for s in inner if s[0].startswith("egonn.step.")]
        want = ["egonn.step.embed", "egonn.step.loss"]
        if train:
            want += ["egonn.step.forward", "egonn.step.backward"] * chunks
            want += ["egonn.step.optimizer"]
        assert [s[0] for s in phases] == want
        names = [s[0] for s in _phases(_inside(spans, phases[0]))]
        per_chunk = ["egonn.quantize", "egonn.pyramid"] + model
        assert names == (["egonn.augment"] if train else []) + per_chunk * chunks
        assert _tconvs_inside(spans, phases[0]) == 2 * chunks
        for p in phases[1:]:
            assert [s[0] for s in _phases(_inside(spans, p))] == (
                model if p[0] == "egonn.step.forward" else [])
            assert _tconvs_inside(spans, p) == {"egonn.step.forward": 2,
                                                "egonn.step.backward": 4}.get(p[0], 0)


def _normalized_synthetic(root: str, n_scans: int) -> None:
    """A synthetic dataset whose scans are Oxford-style submaps: N_POINTS
    points, zero-mean, scaled into [-1, 1]."""
    from egonn_tpu_torch.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(root, n_scans=n_scans)
    rng = np.random.default_rng(0)
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".bin"):
                path = os.path.join(dirpath, name)
                pc = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
                pc = pc[pc[:, 2] > -0.9]
                pc = pc[rng.choice(len(pc), N_POINTS, replace=False)]
                pc[:, :3] -= pc[:, :3].mean(0)
                pc[:, :3] /= np.abs(pc[:, :3]).max()
                pc.astype(np.float32).tofile(path)


def test_do_train_minkloc3dv2_one_epoch(tmp_path):
    """One epoch of the MinkLoc3Dv2 config (batch and split cut to the CPU)
    on submaps: global batches alone, the staged step, a checkpoint, the
    capacity audit in chunks."""
    from egonn_tpu_torch.train.trainer import do_train

    root = str(tmp_path / "synth")
    _normalized_synthetic(root, 96)
    cfg = open(CONFIG).read()
    for a, b in (("dataset = oxford", "dataset = synthetic"),
                 ("/data/pointnetvlad", root), ("batch_size = 2048", "batch_size = 8"),
                 ("batch_split_size = 128", f"batch_split_size = {SPLIT}"),
                 ("epochs = 400", "epochs = 1"), ("250, 350", "5"),
                 ("training_queries_baseline2.pickle", "train_synthetic.pickle"),
                 ("test_queries_baseline2.pickle", "val_synthetic.pickle")):
        assert a in cfg
        cfg = cfg.replace(a, b)
    (tmp_path / "cfg.txt").write_text(cfg)
    model = open(MODEL_CONFIG).read().replace("num_points = 4096", f"num_points = {N_POINTS}")
    model = model.replace("capacities = 4096,3328,2048,896,384",
                          f"capacities = {','.join([str(CAPACITY)] * 5)}")
    (tmp_path / "model.txt").write_text(model)
    tp = tconfig.TrainingParams(str(tmp_path / "cfg.txt"), str(tmp_path / "model.txt"))
    records = []
    state, stats, name = do_train(tp, weights_path=str(tmp_path / "w"), log_fn=records.append,
                                  device="cpu")
    assert stats["train"] and stats["val"] and records[0]["steps"]["train"] >= 2
    assert 0.0 < stats["train"][0]["loss"] < 1.0 and stats["val"][0]["positives_per_query"] > 0
    assert os.path.exists(tmp_path / "w" / name / "step_1.pt")


def test_oxford_loader(tmp_path):
    """PointNetVLAD's submaps: float64 x, y, z triples, nothing filtered."""
    from egonn_tpu_torch.data.base import get_pointcloud_loader
    from egonn_tpu_torch.data.pipeline import default_num_points

    pc = np.random.default_rng(0).uniform(-1, 1, (4096, 3))
    pc[:3] = 0.0
    path = tmp_path / "0.bin"
    pc.tofile(path)
    got = get_pointcloud_loader("oxford")(str(path))
    assert got.dtype == np.float32 and got.shape == (4096, 3)
    np.testing.assert_array_equal(got, pc.astype(np.float32))
    assert default_num_points("oxford") == 4096
