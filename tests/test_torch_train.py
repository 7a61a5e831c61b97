"""Port vs JAX: the EgoNN training step and what surrounds it, on the CPU.

* `TrainingParams` / `ModelParams` field by field for the shipped configs;
* one Adam update against optax's `add_decayed_weights` + `scale_by_adam`
  with p -= lr * u, and the LR schedules;
* the whole step against the JAX composition of the same public pieces
  (`device_preprocess_global` without a key, `model.apply(train=True,
  mutable=["batch_stats"])` threaded through three forwards, `make_losses`,
  `jax.value_and_grad`), on the same weights with augmentation off: the
  JAX trainer's own step always augments when it trains;
* the step's kernel calls per train and validation step (the counts that
  chip_smoke.py asserts on the card);
* a checkpoint round trip: a step from a reloaded state equals a step from
  the live state, bit for bit.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from egonn_tpu import config as jconfig
from egonn_tpu.data.pipeline import device_preprocess_global as j_preprocess
from egonn_tpu.losses.keypoint import make_losses as j_make_losses
from egonn_tpu.models.factory import model_factory
from egonn_tpu.train import state as jstate
from egonn_tpu_torch import config as tconfig
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.train import state as tstate
from egonn_tpu_torch.train.trainer import expansion_buckets, make_train_step

CONFIGS = ["config/config_egonn.txt", "config/config_synthetic.txt",
           "config/config_synthetic_160.txt"]
MODEL_CONFIGS = ["model_configs/egonn.txt", "model_configs/egonn_small.txt",
                 "model_configs/minkloc3d_mulran.txt"]
CAP0, N_POINTS, B_GLOBAL, B_LOCAL, LR = 512, 1024, 4, 2, 1e-3


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def _fields(obj):
    out = {}
    for k, v in vars(obj).items():
        if k == "quantizer":
            out[k] = (type(v).__name__, np.asarray(v.quant_step).tolist())
        elif k != "model_params":
            out[k] = v
    return out


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("model_cfg", MODEL_CONFIGS)
def test_training_params_match(cfg, model_cfg):
    j = jconfig.TrainingParams(cfg, model_cfg, require_dataset=False)
    t = tconfig.TrainingParams(cfg, model_cfg, require_dataset=False)
    assert _fields(t) == _fields(j)
    assert _fields(t.model_params) == _fields(j.model_params)


def test_training_params_quirks(tmp_path):
    cfg = tmp_path / "cfg.txt"
    cfg.write_text("[DEFAULT]\ndataset_folder = /nonexistent\nrot_max = 1.25\n[TRAIN]\n"
                   "scheduler_milestones = 5, 9\nloss = BatchHardTripletMarginLoss\n"
                   "l_gammas = 1, 2, 3, 4\n")
    t = tconfig.TrainingParams(str(cfg), "model_configs/egonn.txt", require_dataset=False)
    assert t.trans_max == t.rot_max == 1.25
    assert t.scheduler == "MultiStepLR" and t.scheduler_milestones == [5, 9]
    assert t.loss_gammas == [1.0, 2.0, 3.0, 4.0] and t.margin == 0.4 and t.aug_mode == 1
    with pytest.raises(FileNotFoundError):
        tconfig.TrainingParams(str(cfg), "model_configs/egonn.txt")


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_adam_matches_optax(rng):
    """Two Adam updates (coupled L2 weight decay 1e-4) against optax on the
    same gradients: equal within f32 rounding (atol 1e-7 on O(1) params)."""
    class P:
        lr, weight_decay = 1e-3, 1e-4

    shapes = {"a": (5, 7), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tstate.make_optimizer(tparams.values(), P)
    tx = jstate.make_optimizer(P)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for step, lr in enumerate((1e-3, 5e-4)):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jp)
        jp = jstate.apply_updates_with_lr(jp, updates, jnp.float32(lr))
        tstate.set_lr(opt, lr)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-7, err_msg=f"{k} step {step}")


@pytest.mark.parametrize("sched", [None, "MultiStepLR", "CosineAnnealingLR"])
def test_lr_schedules(sched):
    class P:
        lr, min_lr, epochs, scheduler, scheduler_milestones = 1e-3, 1e-5, 40, sched, [10, 25]

    j, t = jstate.make_lr_schedule(P), tstate.make_lr_schedule(P)
    for epoch in range(0, 45):
        assert t(epoch) == pytest.approx(float(j(epoch)), rel=1e-6), epoch
    if sched == "MultiStepLR":
        assert t(9) == pytest.approx(1e-3) and t(25) == pytest.approx(1e-5)
    with pytest.raises(NotImplementedError):
        P.scheduler = "Other"
        tstate.make_lr_schedule(P)


def test_expansion_buckets():
    from egonn_tpu.train.trainer import expansion_buckets as j_buckets

    for args in [(32, 128, 1.4, 1), (32, 128, 1.4, 4), (16, 16, None, 1), (24, 100, 1.5, 8)]:
        assert expansion_buckets(*args) == j_buckets(*args)


# ---------------------------------------------------------------------------
# the whole step against JAX
# ---------------------------------------------------------------------------

def _params():
    return (jconfig.TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                                   require_dataset=False),
            tconfig.TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                                   require_dataset=False))


def _batch(seed=0):
    """4 global clouds (2 places, the second scan of a place rotated and
    shifted) and 2 pairs whose positive is the anchor under t_gt."""
    rng = np.random.default_rng(seed)
    base = lidar_scan_clouds(B_GLOBAL // 2 + B_LOCAL, N_POINTS, seed=seed) * 0.3
    glob = []
    for i in range(B_GLOBAL // 2):
        th = rng.uniform(-0.15, 0.15)
        rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        glob += [base[i], base[i] @ rot.T + rng.normal(0, 0.3, 3)]
    glob = np.stack(glob).astype(np.float32)
    labels = np.arange(B_GLOBAL) // 2
    pos = (labels[:, None] == labels[None]) & ~np.eye(B_GLOBAL, dtype=bool)
    neg = labels[:, None] != labels[None]
    anc = base[B_GLOBAL // 2:].astype(np.float32)
    t_gt = np.tile(np.eye(4, dtype=np.float32), (B_LOCAL, 1, 1))
    for i in range(B_LOCAL):
        th = rng.uniform(-0.2, 0.2)
        t_gt[i, :2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        t_gt[i, :2, 3] = rng.uniform(-1, 1, 2)
    positive = (anc @ np.transpose(t_gt[:, :3, :3], (0, 2, 1)) + t_gt[:, None, :3, 3])
    ones = np.ones((B_GLOBAL, N_POINTS), bool)
    g = dict(clouds=glob, point_mask=ones, positives_mask=pos, negatives_mask=neg)
    l = dict(anc_clouds=anc, anc_mask=ones[:B_LOCAL], pos_clouds=positive.astype(np.float32),
             pos_mask=ones[:B_LOCAL], t_gt=t_gt)
    return g, l


def _flax_tree(model):
    """The port's state dict as a flax {params, batch_stats} tree."""
    tree = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        parts = key.split(".")
        node = tree["batch_stats" if parts[-1] in ("mean", "var") else "params"]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.numpy().copy()
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def step_pair():
    jp, tp = _params()
    g, l = _batch()
    built_t = create_egonn_model(tp.model_params, cap0=CAP0, device="cpu", seed=1)
    variables = _flax_tree(built_t.model)
    params0 = copy.deepcopy(variables["params"])

    step = make_train_step(built_t, tp)
    stats_t = step({k: torch.from_numpy(v) for k, v in g.items()},
                   {k: torch.from_numpy(v) for k, v in l.items()}, None, LR, True)
    grads_t = {n: p.grad.numpy().copy() for n, p in built_t.model.named_parameters()}

    built_j = model_factory(jp.model_params, cap0=CAP0)
    model, q, spec = built_j.model, built_j.quantizer, built_j.pyramid_spec
    gl_fn, loc_fn = j_make_losses(jp)

    def forward(params, bs, clouds, mask):
        pyr = j_preprocess(clouds, mask, q, spec)
        y, mut = model.apply({"params": params, "batch_stats": bs}, pyr, q, train=True,
                             mutable=["batch_stats"])
        return y, mut["batch_stats"]

    def loss_fn(params, bs):
        yg, bs1 = forward(params, bs, g["clouds"], g["point_mask"])
        gl, gl_stats = gl_fn(yg["global"], g["positives_mask"], g["negatives_mask"])
        y1, bs2 = forward(params, bs1, l["anc_clouds"], l["anc_mask"])
        y2, bs3 = forward(params, bs2, l["pos_clouds"], l["pos_mask"])
        ll, loc_stats = loc_fn(l["anc_clouds"], l["anc_mask"], y1["keypoints"], y1["sigma"],
                               y1["descriptors"], y1["kp_mask"], l["pos_clouds"], l["pos_mask"],
                               y2["keypoints"], y2["sigma"], y2["descriptors"], y2["kp_mask"],
                               l["t_gt"])
        stats = {k: v for k, v in {**gl_stats, **loc_stats}.items() if k != "loss"}
        stats.update(global_loss=gl, local_loss=ll, loss=gl + ll)
        return gl + ll, (stats, bs3)

    (_, (stats_j, bs_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    tx = jstate.make_optimizer(jp)
    updates, _ = tx.update(grads_j, tx.init(params0), params0)
    new_j = jstate.apply_updates_with_lr(params0, updates, jnp.float32(LR))
    return dict(stats_t=stats_t, stats_j=stats_j, grads_t=grads_t, grads_j=_flat(grads_j),
                bs_j=_flat(bs_j), new_j=_flat(new_j), params0=_flat(params0), tp=tp,
                state=built_t.model.state_dict())


def _check_stats(s_t, s_j):
    assert set(s_t) == set(s_j)
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(s_t["loss"]) == pytest.approx(float(s_t["global_loss"] + s_t["local_loss"]))
    assert float(s_t["num_triplets"]) == B_GLOBAL and float(s_t["matching_keypoints"]) > 0


def _check_gradients(g_t, g_j):
    assert set(g_t) == set(g_j)
    for name, want in g_j.items():
        scale = float(np.abs(want).max())
        assert scale > 0, name
        err = float(np.abs(g_t[name] - want).max())
        assert err <= 1e-3 * scale, (name, err, scale)


def _check_batch_norm(state, bs_j):
    assert len(bs_j) == sum(k.endswith((".mean", ".var")) for k in state)
    for k, want in bs_j.items():
        np.testing.assert_allclose(np.asarray(state[k]), want, rtol=1e-5, atol=1e-6, err_msg=k)


def _check_update(state, p0, g_t, new_j, tp):
    tx = jstate.make_optimizer(tp)
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in g_t.items()},
                           tx.init({k: jnp.asarray(v) for k, v in p0.items()}),
                           {k: jnp.asarray(v) for k, v in p0.items()})
    for name, u in updates.items():
        want = p0[name] - np.float32(LR) * np.asarray(u)
        got = np.asarray(state[name])
        # within 2 ulp: torch and optax round the moments' updates differently
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-7, err_msg=name)
        assert not np.array_equal(got, p0[name]), name
        g_l2 = g_t[name] + tp.weight_decay * p0[name]  # what Adam sees
        strong = np.abs(g_l2) > 1e-3 * np.abs(g_l2).max()
        np.testing.assert_allclose(got[strong], new_j[name][strong], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_step_loss_and_stats(step_pair):
    """Every stat within rel 1e-5 (atol 1e-6): f32 forwards whose
    summation orders differ."""
    _check_stats(step_pair["stats_t"], step_pair["stats_j"])


def test_step_gradients(step_pair):
    """Every parameter's gradient: max abs error <= 1e-3 x the leaf's max
    |grad| (measured 2.4e-5 on this batch).  The bound is loose because a
    ReLU's derivative jumps at 0: a pre-activation within f32 rounding of 0
    may take the other branch on the other side, and one such element moves
    the gradients below it by several 1e-3 of their max at this small size
    (seen with other seeds for the weights; each piece's own gradient is
    held at 1e-5 in tests/test_torch_train_ops.py and test_torch_losses.py)."""
    _check_gradients(step_pair["grads_t"], step_pair["grads_j"])


def test_step_batch_norm_statistics(step_pair):
    """The running statistics after the three forwards: rtol 1e-5."""
    _check_batch_norm(step_pair["state"], step_pair["bs_j"])


def test_step_parameter_update(step_pair):
    """The update: the port's new parameters are optax's update of the
    port's own gradients (within 2 ulp), and JAX's new parameters wherever the
    gradient Adam sees (g + wd * p) is well above the two sides' gradient
    difference (> 1e-3 x the leaf's max): Adam's first step moves each weight
    by ~lr * sign(g + wd * p), so one that is zero up to rounding may move
    either way."""
    _check_update(step_pair["state"], step_pair["params0"], step_pair["grads_t"],
                  step_pair["new_j"], step_pair["tp"])


def test_two_rank_step_matches_jax(step_pair, tmp_path):
    """The step on 2 gloo ranks (2 global clouds and 1 pair each, the same
    weights) against JAX's unsharded step, which is the function JAX's mesh
    computes (tests/test_multichip.py): stats, gradients, BatchNorm
    statistics and the update at the tolerances of the four tests above;
    after the step both ranks' parameters, BatchNorm statistics and Adam
    moments are bit-equal."""
    from egonn_tpu_torch.parallel import dryrun
    from egonn_tpu_torch.parallel.mesh import run_ranks

    g, l = _batch()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # the spawned rank takes this count
    try:
        ranks = run_ranks(dryrun.rank_step, 2, (step_pair["tp"], CAP0, 1, g, l, None, LR, "cpu"),
                          init_method=f"file://{tmp_path / 'init'}", timeout_s=120.0)
    finally:
        torch.set_num_threads(threads)
    r0 = ranks[0]
    _check_stats(r0["stats"], step_pair["stats_j"])
    _check_gradients(r0["grads"], step_pair["grads_j"])
    _check_batch_norm(r0["state"], step_pair["bs_j"])
    _check_update(r0["state"], step_pair["params0"], r0["grads"], step_pair["new_j"],
                  step_pair["tp"])
    for k, v in r0["state"].items():
        assert np.array_equal(ranks[1]["state"][k], v), k
    for n, moments in r0["adam"].items():
        assert all(np.array_equal(a, b) for a, b in zip(ranks[1]["adam"][n], moments)), n


# ---------------------------------------------------------------------------
# launches, validation, checkpoints (port only)
# ---------------------------------------------------------------------------

def _torch_batch(seed=0):
    g, l = _batch(seed)
    return ({k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in l.items()})


def test_kernel_calls_per_step(monkeypatch):
    """Kernel calls of one train step and one validation step at a small
    size: the structure, and so the counts, of the full-width step (the
    card's but for `slot_order`: a CPU level builds no slot order, its
    transposed convs multiply all slots)."""
    _, tp = _params()
    built = create_egonn_model(tp.model_params, cap0=CAP0, device="cpu")
    step = make_train_step(built, tp)
    calls = {}
    for fn in kernels.KERNELS:
        def counted(*a, _fn=fn, **k):
            calls[_fn.__name__] = calls.get(_fn.__name__, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, fn.__name__, counted)
    g, l = _torch_batch()
    for train, want in ((True, chip_smoke.TRAIN_STEP_LAUNCHES),
                        (False, chip_smoke.VAL_STEP_LAUNCHES)):
        calls.clear()
        step(g, l, torch.Generator().manual_seed(0) if train else None, LR, train)
        want = dict(want, slot_order=0)
        assert {k: calls.get(k, 0) for k in want} == want, train
    assert not built.model.training


def test_validation_step_changes_nothing():
    _, tp = _params()
    built = create_egonn_model(tp.model_params, cap0=CAP0, device="cpu")
    step = make_train_step(built, tp)
    g, l = _torch_batch()
    step(g, l, None, LR, True)  # optimizer state exists
    before = copy.deepcopy(built.model.state_dict())
    opt_before = copy.deepcopy(step.state.optimizer.state_dict())
    stats = step(g, l, torch.Generator().manual_seed(1), LR, False)
    again = step(g, l, torch.Generator().manual_seed(2), LR, False)
    assert all(torch.equal(v, built.model.state_dict()[k]) for k, v in before.items())
    opt_after = step.state.optimizer.state_dict()
    for i, st in opt_before["state"].items():
        assert all(torch.equal(v, opt_after["state"][i][k]) for k, v in st.items())
    assert all(torch.equal(stats[k], again[k]) for k in stats)  # no augmentation
    assert float(stats["loss"]) == pytest.approx(float(stats["global_loss"] + stats["local_loss"]))


def test_checkpoint_round_trip(tmp_path):
    """Step 1, save, step 2 live; then a fresh model (other weights) loads
    the checkpoint and takes step 2: stats, parameters, BN statistics and
    optimizer state bit-equal."""
    _, tp = _params()
    g, l = _torch_batch()

    def new_step(seed):
        return make_train_step(create_egonn_model(tp.model_params, cap0=CAP0, device="cpu",
                                                  seed=seed), tp)

    live = new_step(0)
    live(g, l, torch.Generator().manual_seed(1), LR, True)
    live.state.epoch = 1
    tstate.save_checkpoint(str(tmp_path), live.state, 1, extra_meta={"sampler_batch_size": 45})
    stats_live = live(g, l, torch.Generator().manual_seed(2), LR / 2, True)

    resumed = new_step(5)
    assert tstate.load_checkpoint(str(tmp_path), resumed.state) == 1
    assert resumed.state.epoch == 1
    assert tstate.load_checkpoint_meta(str(tmp_path), 1) == {"sampler_batch_size": 45}
    assert tstate.load_checkpoint_meta(str(tmp_path), 7) == {}
    stats_resumed = resumed(g, l, torch.Generator().manual_seed(2), LR / 2, True)
    assert all(torch.equal(stats_live[k], stats_resumed[k]) for k in stats_live)
    a, b = live.state.model.state_dict(), resumed.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = live.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, st in oa["state"].items():
        assert all(torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k]))
                   for k, v in st.items())
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tstate.load_checkpoint(str(tmp_path / "empty"), resumed.state)
