"""Port vs JAX: the EgoNN train step under the bf16 accelerator numerics.

Under EGONN_BF16_ACTS=1 the JAX package trains with bf16 activations on a
TPU: the cotangents of bf16 activations are bf16, every dX conv is a bf16
conv, and every conv dW multiplies bf16 features by bf16 cotangents into f32
sums (`banded_conv_dw`); BatchNorm statistics, the heads' outputs, the
losses, the parameters' gradients and Adam stay f32.  The port does the same
on a CUDA card.  Both keep f32 on the CPU, so these tests patch
`activation_dtype` on both sides, as tests/test_torch_bf16.py does.

Tolerances:
* `gather_dw_plain` on bf16 inputs against JAX's `_conv_dkernel_gather` on
  the same bf16 arrays: rtol 1e-5 and atol 1e-5 x max |JAX| (exact
  products, f32 sums of up to 2 x C_out rows in another order: an element
  that nearly cancels keeps the sums' absolute rounding, 1.6e-5 on sums of
  magnitude ~10 at L2, F 128); against the Pallas dW kernel in interpret mode: 3e-2 of
  max |Pallas| (tests/test_banded.py's bf16 rule);
* the three custom-gradient convs against `jax.vjp` on bf16 features and
  bf16-representable weights, so that JAX's CPU engine, which multiplies
  bf16 features by f32 weights, forms the same exact products (known
  difference 24): dW within 1e-5 of max |JAX|; outputs and dX within one
  bf16 ulp, at most 1% of them a sum-order flip;
* SparseBatchNorm's train-mode backward on bf16 input against flax's: dX
  bf16 within 3e-2 of max |flax| (one bf16 rounding of the same f32
  value), dscale and dbias f32 within 1e-3 of their max;
* the whole step (tests/test_torch_train.py's composition) on
  bf16-representable weights: stats within STAT_REL_TOL, BatchNorm running
  statistics within BN_REL_TOL, gradients as `test_bf16_step_gradients`
  states (measured there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads
import chip_smoke
from egonn_tpu.data.pipeline import device_preprocess_global as j_preprocess
from egonn_tpu.losses.keypoint import make_losses as j_make_losses
from egonn_tpu.models.factory import model_factory
from egonn_tpu.sparse import banded as jbanded
from egonn_tpu.sparse import conv as jconv
from egonn_tpu.sparse import norm as jnorm
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse import conv as tconv
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.train import trainer as ttrainer
from egonn_tpu_torch.train.state import load_checkpoint, save_checkpoint
from test_torch_train import CAP0, LR, _batch, _flat, _flax_tree, _params

STEPS = [1.0, 0.3, 0.2]
BF16_RULE = 3e-2
DW_TOL = 1e-5
STAT_REL_TOL, BN_REL_TOL = 3e-2, 3e-2


def _bf16_patch(mp):
    """bf16 activations on the CPU, on both sides."""
    mp.setattr(tconv, "activation_dtype", lambda device: torch.bfloat16)
    mp.setattr(jconv, "activation_dtype", lambda: jnp.bfloat16)


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


def _as_bf16(x) -> torch.Tensor:
    """A bf16-valued array (numpy, or JAX in any float type) as a torch bf16
    tensor, exactly."""
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)


def _hold_bf16(got: torch.Tensor, want, what: str) -> None:
    """bf16 against JAX's bf16: within one ulp, at most 1% of the elements a
    one-ulp flip (the same f32 sums in another order, rounded once)."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, what
    ulps = kernels.bf16_ulps(got, _as_bf16(want))
    assert int(ulps.max()) <= 1, (what, int(ulps.max()))
    assert float((ulps > 0).float().mean()) <= 0.01, (what, float((ulps > 0).float().mean()))
    assert float(np.abs(np.asarray(want, np.float32)).max()) > 0.1, what


def _hold_dw(got: torch.Tensor, want, what: str) -> None:
    assert got.dtype == torch.float32 and want.dtype == jnp.float32, what
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got.numpy() - want).max())
    assert err <= DW_TOL * scale, (what, err, scale)


@pytest.fixture(scope="module")
def pyr():
    """The port's pyramid with kmap_down, 5 levels at cap0 1024 (the maps
    are bit-equal to JAX's: tests/test_torch_train_ops.py)."""
    clouds = torch.from_numpy(lidar_scan_clouds(2, 4096, seed=3))
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    mask[1, 3000:] = False
    spec = tpyr.egonn_pyramid_spec(cap0=1024, num_levels=5)
    res = PolarQuantizer(STEPS).quantize(clouds, mask, spec.capacities[0], need_index=False)
    return tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys, with_kmap_down=True)


def _feats(rng, shape, mask=None, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if mask is not None:
        x = x * mask.numpy()[..., None]
    return _bf16_values(x)


# ---------------------------------------------------------------------------
# gather_dw's bf16 plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,level,f_in,f_out", [("self", 1, 16, 32), ("down", 2, 64, 64),
                                                   ("self", 2, 128, 128)])
def test_gather_dw_plain_bf16_matches_jax(pyr, rng, kind, level, f_in, f_out):
    """bf16 features and g (and an f32 g, which the wrapper rounds) against
    `_conv_dkernel_gather` on the same bf16 arrays: f32 out."""
    kmap = pyr[level].kmap_self if kind == "self" else pyr[level].kmap_down
    src = pyr[level] if kind == "self" else pyr[level - 1]
    feats = _feats(rng, (2, src.capacity, f_in), src.mask)
    g32 = rng.standard_normal((2, kmap.shape[2], f_out)).astype(np.float32)
    g32 *= pyr[level].mask.numpy()[..., None]
    g = _bf16_values(g32)
    want = jconv._conv_dkernel_gather(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(kmap.numpy()),
                                      jnp.asarray(g, jnp.bfloat16))
    assert want.dtype == jnp.float32
    got = kernels.gather_dw(_as_bf16(feats), kmap, _as_bf16(g))
    assert got.dtype == torch.float32 and got.shape == (kmap.shape[1], f_in, f_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=DW_TOL * float(np.abs(np.asarray(want)).max()))
    assert torch.equal(kernels.gather_dw(_as_bf16(feats), kmap, torch.from_numpy(g32)), got)
    assert float(np.abs(np.asarray(want)).max()) > 1.0


@pytest.mark.parametrize("kind", ["self", "down"])
def test_gather_dw_plain_bf16_matches_pallas_interpret(pyr, rng, kind):
    """Against the Pallas dW kernel in interpret mode (bf16 operands, f32
    sums) at tests/test_banded.py::test_banded_dw_matches_gather_backward's
    widths and level: within 3e-2 of max |Pallas|."""
    lvl = pyr[1]
    kmap = lvl.kmap_self if kind == "self" else lvl.kmap_down
    c_in = lvl.capacity if kind == "self" else pyr[0].capacity
    feats = rng.standard_normal((2, c_in, 16)).astype(np.float32)
    g = rng.standard_normal((2, lvl.capacity, 24)).astype(np.float32)
    want = jbanded.banded_conv_dw(jnp.asarray(feats), jnp.asarray(kmap.numpy()), jnp.asarray(g),
                                  interpret=True)
    assert want is not None
    want = np.asarray(want)
    got = kernels.gather_dw_plain(torch.from_numpy(feats).to(torch.bfloat16), kmap,
                                  torch.from_numpy(g))
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max())
    assert err <= BF16_RULE * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# the custom-gradient convs on bf16 features
# ---------------------------------------------------------------------------

def _vjps(j_fn, t_fn, feats, kernel, g, maps):
    """(JAX out, dX, dW), (port out, dX, dW) on bf16 features and g and the
    f32 (bf16-valued) kernel."""
    jm = [jnp.asarray(m.numpy()) for m in maps]
    out_j, vjp = jax.vjp(lambda x, w: j_fn(x, *jm, w), jnp.asarray(feats, jnp.bfloat16),
                         jnp.asarray(kernel))
    dx_j, dw_j = vjp(jnp.asarray(g, jnp.bfloat16))
    x = _as_bf16(feats).requires_grad_()
    w = torch.from_numpy(kernel).requires_grad_()
    out_t = t_fn(x, *maps, w)
    out_t.backward(_as_bf16(g))
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    return (out_j, dx_j, dw_j), (out_t.detach(), x.grad, w.grad)


def _hold_vjps(j, t):
    for what, got, want in zip(("out", "dX"), t[:2], j[:2]):
        _hold_bf16(got, want, what)
    _hold_dw(t[2], j[2], "dW")


@pytest.mark.parametrize("level,f_in,f_out", [(1, 32, 64), (2, 64, 128)])
def test_sparse_conv_sym_bf16_vjp(pyr, rng, level, f_in, f_out):
    lvl = pyr[level]
    feats = _feats(rng, (2, lvl.capacity, f_in), lvl.mask)
    kernel = _bf16_values(rng.standard_normal((27, f_in, f_out)) / np.sqrt(27 * f_in))
    g = _feats(rng, (2, lvl.capacity, f_out), lvl.mask)
    _hold_vjps(*_vjps(jconv.sparse_conv_sym, tconv.sparse_conv_sym, feats, kernel, g,
                      [lvl.kmap_self]))


@pytest.mark.parametrize("level,f", [(1, 32), (3, 64)])
def test_sparse_conv_down_bf16_vjp(pyr, rng, level, f):
    """The down conv into `level` from level - 1; its dX is the transposed
    conv in f32 on the bf16 values, rounded once (JAX's promote-then-cast)."""
    fine, coarse = pyr[level - 1], pyr[level]
    feats = _feats(rng, (2, fine.capacity, f), fine.mask)
    kernel = _bf16_values(rng.standard_normal((8, f, f)) / np.sqrt(8 * f))
    g = _feats(rng, (2, coarse.capacity, f), coarse.mask)
    _hold_vjps(*_vjps(jconv.sparse_conv_down, tconv.sparse_conv_down, feats, kernel, g,
                      [coarse.kmap_down, fine.up_parent, fine.up_koffset]))


@pytest.mark.parametrize("level,f_in,f_out", [(2, 64, 64), (3, 128, 64)])
def test_sparse_tconv2x2_bf16_vjp(pyr, rng, level, f_in, f_out):
    """The transposed conv from `level` + 1 onto `level`; its dW is an f32
    einsum on the bf16 values (JAX's preferred_element_type)."""
    fine, coarse = pyr[level], pyr[level + 1]
    feats = _feats(rng, (2, coarse.capacity, f_in), coarse.mask)
    kernel = _bf16_values(rng.standard_normal((8, f_in, f_out)) / np.sqrt(8 * f_in))
    g = _feats(rng, (2, fine.capacity, f_out), fine.mask)
    _hold_vjps(*_vjps(jconv.sparse_tconv2x2_vjp, tconv.sparse_tconv2x2_vjp, feats, kernel, g,
                      [fine.up_parent, fine.up_koffset, coarse.kmap_down]))


def test_sparse_batch_norm_bf16_backward(rng):
    """Train-mode BN on bf16 input: dX bf16 from the f32 statistics, as
    flax's through its casts; dscale and dbias f32."""
    b, c, f = 2, 300, 24
    mask = rng.random((b, c)) < 0.8
    feats = _bf16_values((rng.standard_normal((b, c, f)) * 2.0 + 0.5).astype(np.float32)
                         * mask[..., None])
    g = _bf16_values(rng.standard_normal((b, c, f)).astype(np.float32))
    params = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
              "bias": rng.normal(0, 0.3, f).astype(np.float32)}
    stats = {"mean": np.zeros(f, np.float32), "var": np.ones(f, np.float32)}

    def j_fn(x, p):
        y, _ = jnorm.SparseBatchNorm(f).apply({"params": p, "batch_stats": stats}, x,
                                              jnp.asarray(mask), True, mutable=["batch_stats"])
        return y

    _, vjp = jax.vjp(j_fn, jnp.asarray(feats, jnp.bfloat16),
                     {k: jnp.asarray(v) for k, v in params.items()})
    dx_j, dp_j = vjp(jnp.asarray(g, jnp.bfloat16))
    bn = SparseBatchNorm(f).train()
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    x = _as_bf16(feats).requires_grad_()
    y = bn(x, torch.from_numpy(mask))
    assert y.dtype == torch.bfloat16
    y.backward(_as_bf16(g))
    assert x.grad.dtype == torch.bfloat16 and dx_j.dtype == jnp.bfloat16
    want = np.asarray(dx_j, np.float32)
    assert float(np.abs(x.grad.float().numpy() - want).max()) <= BF16_RULE * float(
        np.abs(want).max())
    for k in ("scale", "bias"):
        got, want = getattr(bn, k).grad, np.asarray(dp_j[k])
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert float(np.abs(got.numpy() - want).max()) <= 1e-3 * float(np.abs(want).max()), k


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

def _count_calls(mp, calls: dict):
    """Every kernel wrapper counted under its kernel row: a conv or dW on
    bf16 features under its bf16 row (chip_smoke.row_of)."""
    for fn in kernels.KERNELS:
        def counted(*a, _fn=fn, **k):
            row = chip_smoke.row_of(_fn.__name__, a)
            calls[row] = calls.get(row, 0) + 1
            return _fn(*a, **k)
        mp.setattr(kernels, fn.__name__, counted)


def _jax_step(jp, variables, g, l):
    """tests/test_torch_train.py's JAX composition of the step: (stats,
    gradients, BatchNorm statistics after the three forwards)."""
    built_j = model_factory(jp.model_params, cap0=CAP0)
    model, q, spec = built_j.model, built_j.quantizer, built_j.pyramid_spec
    gl_fn, loc_fn = j_make_losses(jp)

    def forward(params, bs, clouds, mask):
        y, mut = model.apply({"params": params, "batch_stats": bs}, j_preprocess(clouds, mask, q,
                                                                                spec),
                             q, train=True, mutable=["batch_stats"])
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

    (_, (stats, bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return stats, _flat(grads), _flat(bs)


@pytest.fixture(scope="module")
def bf16_step():
    """One bf16 train step of the port and of JAX from the same
    bf16-representable weights, augmentation off; the port's kernel calls
    per train step and per validation step (after it)."""
    jp, tp = _params()
    g, l = _batch()
    built = create_egonn_model(tp.model_params, cap0=CAP0, device="cpu", seed=1)
    with torch.no_grad():
        for p in built.model.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    variables = _flax_tree(built.model)
    calls = {True: {}, False: {}}
    with pytest.MonkeyPatch.context() as mp:
        _bf16_patch(mp)
        stats_j, grads_j, bs_j = _jax_step(jp, variables, g, l)
        step = ttrainer.make_train_step(built, tp)
        gt = {k: torch.from_numpy(v) for k, v in g.items()}
        lt = {k: torch.from_numpy(v) for k, v in l.items()}
        with pytest.MonkeyPatch.context() as counting:
            _count_calls(counting, calls[True])
            stats_t = step(gt, lt, None, LR, True)
        grads_t = {n: p.grad.detach().clone() for n, p in built.model.named_parameters()}
        state = {k: v.clone() for k, v in built.model.state_dict().items()}
        with pytest.MonkeyPatch.context() as counting:
            _count_calls(counting, calls[False])
            val_stats = step(gt, lt, None, LR, False)
    return dict(stats_t=stats_t, stats_j=stats_j, grads_t=grads_t, grads_j=grads_j,
                state=state, bs_j=bs_j, calls=calls, val_stats=val_stats)


def test_bf16_step_loss_and_stats(bf16_step):
    """Every stat within STAT_REL_TOL of JAX's (relative, atol 1e-3 for
    stats near 0); finite, f32, the loss the sum of its parts."""
    s_t, s_j = bf16_step["stats_t"], bf16_step["stats_j"]
    assert set(s_t) == set(s_j)
    for k, want in s_j.items():
        got = s_t[k]
        assert got.dtype == torch.float32 and bool(torch.isfinite(got)), k
        assert abs(float(got) - float(want)) <= STAT_REL_TOL * abs(float(want)) + 1e-3, (
            k, float(got), float(want))
    assert float(s_t["loss"]) == pytest.approx(float(s_t["global_loss"] + s_t["local_loss"]))
    assert all(bool(torch.isfinite(v)) for v in bf16_step["val_stats"].values())


def test_bf16_step_gradients(bf16_step):
    """Every parameter's gradient f32, held by `chip_smoke.bf16_grad_check`
    (the rule phase 5b holds the card to against the CPU): all leaves
    together within BF16_WHOLE_L2_TOL (0.15) in l2 and each at cosine >=
    BF16_COS_MIN (0.8) with JAX's; and the local head's leaves (its convs,
    decoder and regressors, which only the local losses reach) each within
    BF16_GRAD_MAX_TOL (3e-2) of its max |JAX grad| and BF16_GRAD_L2_TOL
    (1e-2) of its l2 norm (measured 3.8e-4 and 1.7e-4).  At this size (L7
    holds 9 voxels of the 4 global clouds) the global loss's backward
    through the deep levels' batch statistics magnifies single bf16
    roundings: the port's own f32 gradients differ from its bf16 ones by up
    to 24% (l2) on the deepest leaves, as much as the port's bf16 gradients
    differ from JAX's (22%; 0.034 over all leaves, the worst cosine 0.976).
    One process in four of this fixture measured another outcome of the
    port's bf16 global path (the global loss 0.2111 against 0.2084; each
    process repeats its own bit for bit; cause not found): 0.055 over all,
    the worst cosine 0.871."""
    g_t, g_j = bf16_step["grads_t"], bf16_step["grads_j"]
    assert set(g_t) == set(g_j)
    assert all(g.dtype == torch.float32 for g in g_t.values())
    assert sum(n.startswith("local_") for n in g_j) == 15
    check = chip_smoke.bf16_grad_check(g_t, {n: torch.from_numpy(np.array(w))
                                             for n, w in g_j.items()}, local_leaves=True)
    assert check["ok"], check


def test_bf16_step_batch_norm_statistics(bf16_step):
    """The running statistics after the three forwards, f32, within
    BN_REL_TOL of JAX's (of each leaf's max)."""
    state, bs_j = bf16_step["state"], bf16_step["bs_j"]
    assert len(bs_j) == sum(k.endswith((".mean", ".var")) for k in state)
    for k, want in bs_j.items():
        got = state[k]
        assert got.dtype == torch.float32, k
        err = float(np.abs(got.numpy() - want).max())
        assert err <= BN_REL_TOL * float(np.abs(want).max()), (k, err)


def test_bf16_kernel_calls_per_step(bf16_step):
    """The kernel calls of one bf16 train step and one validation step, each
    conv and dW under its bf16 row: the counts chip_smoke.py asserts on the
    card (BF16_TRAIN_STEP_LAUNCHES, BF16_VAL_STEP_LAUNCHES); no conv or dW
    runs on f32 features."""
    for train, want in ((True, chip_smoke.BF16_TRAIN_STEP_LAUNCHES),
                        (False, chip_smoke.BF16_VAL_STEP_LAUNCHES)):
        calls = bf16_step["calls"][train]
        assert {k: calls.get(k, 0) for k in want} == want, train
        assert set(calls) <= set(want), train


# ---------------------------------------------------------------------------
# make_train_step, checkpoints and do_train under the flag (port only)
# ---------------------------------------------------------------------------

def test_train_step_resumes_bf16(monkeypatch, tmp_path):
    """`make_train_step` with bf16 activations: step 1, checkpoint, step 2
    live; a fresh model (other weights) loads the checkpoint and takes step
    2: stats, parameters, BatchNorm statistics and Adam's state bit-equal,
    all f32; every dW on bf16 features.  (The card's phase 5b resumes a
    bf16 `do_train` from its epoch-1 checkpoint.)"""
    _, tp = _params()
    g, l = (({k: torch.from_numpy(v) for k, v in d.items()}) for d in _batch())
    dw_types, gather_dw = set(), kernels.gather_dw

    def recorded(feats, kmap, gg):
        dw_types.add(feats.dtype)
        return gather_dw(feats, kmap, gg)

    monkeypatch.setattr(tconv, "activation_dtype", lambda device: torch.bfloat16)
    monkeypatch.setattr(kernels, "gather_dw", recorded)

    def new_step(seed):
        return ttrainer.make_train_step(create_egonn_model(tp.model_params, cap0=CAP0,
                                                           device="cpu", seed=seed), tp)

    live = new_step(0)
    live(g, l, torch.Generator().manual_seed(1), LR, True)
    live.state.epoch = 1
    save_checkpoint(str(tmp_path), live.state, 1)
    stats_live = live(g, l, torch.Generator().manual_seed(2), LR / 2, True)
    resumed = new_step(5)
    assert load_checkpoint(str(tmp_path), resumed.state) == 1
    stats_resumed = resumed(g, l, torch.Generator().manual_seed(2), LR / 2, True)
    assert dw_types == {torch.bfloat16}
    assert all(torch.equal(stats_live[k], stats_resumed[k]) for k in stats_live)
    a, b = _state(live.state), _state(resumed.state)
    assert a.keys() == b.keys() and any(k.startswith("adam.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert not a[k].is_floating_point() or a[k].dtype == torch.float32, k


def _state(state) -> dict:
    """A TrainState's tensors: the model's state dict and Adam's state."""
    out = dict(state.model.state_dict())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v) for k, v in st.items()})
    return out


def _bf16_rank_step(group, *args):
    """`dryrun.rank_step` with bf16 activations on this rank, and the
    feature types its dW calls saw."""
    from egonn_tpu_torch.parallel import dryrun

    types, dtype_fn, gather_dw = set(), tconv.activation_dtype, kernels.gather_dw

    def recorded(feats, kmap, g):
        types.add(str(feats.dtype))
        return gather_dw(feats, kmap, g)

    tconv.activation_dtype = lambda device: torch.bfloat16
    kernels.gather_dw = recorded
    try:
        return dict(dryrun.rank_step(group, *args), dw_types=types)
    finally:
        tconv.activation_dtype, kernels.gather_dw = dtype_fn, gather_dw


def test_two_rank_bf16_step(tmp_path):
    """The data-parallel step with bf16 activations on 2 gloo ranks (2 global
    clouds and 1 pair each) runs: finite stats, f32 gradients, every dW on
    bf16 features, and after the step both ranks' parameters, BatchNorm
    statistics and Adam moments bit-equal."""
    from egonn_tpu_torch.parallel.mesh import run_ranks

    _, tp = _params()
    g, l = _batch()
    with torch_threads.shared_by(2):
        ranks = run_ranks(_bf16_rank_step, 2, (tp, CAP0, 1, g, l, None, LR, "cpu"),
                          init_method=f"file://{tmp_path / 'init'}", timeout_s=120.0)
    for r in ranks:
        assert r["dw_types"] == {"torch.bfloat16"}
        assert all(np.isfinite(v) for v in r["stats"].values())
        assert all(v.dtype == np.float32 for v in r["grads"].values())
    r0, r1 = ranks
    assert all(np.array_equal(r1["state"][k], v) for k, v in r0["state"].items())
    assert all(all(np.array_equal(a, b) for a, b in zip(r1["adam"][n], m))
               for n, m in r0["adam"].items())
