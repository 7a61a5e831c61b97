"""Port vs JAX: the training half of the sparse ops on the CPU.

* train-mode SparseBatchNorm against flax with mutable=["batch_stats"];
* `kmap_down` against the JAX pyramid's, bit for bit, at every level;
* the three custom-gradient convs (`sparse_conv_sym`, `sparse_conv_down`,
  `sparse_tconv2x2_vjp`) against `jax.vjp` of the JAX package's, and
  against torch.autograd of the plain forward;
* `gather_dw_plain` against the JAX package's exact dW and against the
  Pallas dW kernel in interpret mode.

JAX on the CPU takes its exact gather engine and f32 matmuls at precision
highest (tests/conftest.py), so f32 results differ by summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse import conv as jconv
from egonn_tpu.sparse import norm as jnorm
from egonn_tpu.sparse import pyramid as jpyr
from egonn_tpu.sparse.banded import banded_conv_dw
from egonn_tpu_torch.sparse import conv as tconv
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.sparse.packing import pack_keys

STEPS = [1.0, 0.3, 0.2]
# f32 on both sides; dX sums <= 27 x 128 products, dW up to B x C_out rows
# per weight: max abs error <= 1e-5 x max |JAX|
REL_TOL = 1e-5


def _clouds(seed, b=2, n=4096):
    """The cloud shape of tests/test_banded.py::_real_pyramid."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = np.abs(rng.normal(25, 18, (b, n))).clip(2, 80)
    z = rng.uniform(-1, 10, (b, n))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pyramids():
    """The JAX pyramid (all maps, kmap_down included) and the port's (with
    kmap_down) from one quantization, 7 levels at cap0 1024."""
    clouds = _clouds(0)
    mask = np.ones(clouds.shape[:2], bool)
    mask[1, 3000:] = False
    jspec = jpyr.egonn_pyramid_spec(cap0=1024)
    tspec = tpyr.egonn_pyramid_spec(cap0=1024)
    jq = JPolar(STEPS)
    res = jax.vmap(lambda p, m: jq.quantize(p, m, jspec.capacities[0], need_index=False))(
        jnp.asarray(clouds), jnp.asarray(mask))
    jp = jax.jit(lambda c, m, k: jpyr.build_pyramid(c, m, jspec, keys0=k))(
        res.coords_t, res.mask, res.keys)
    coords, m0, keys = (torch.from_numpy(np.array(a)) for a in (res.coords_t, res.mask, res.keys))
    tp = tpyr.build_pyramid(coords, m0, tspec, keys0=keys, with_kmap_down=True)
    return jp, tp, tspec


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("all_masked", [False, True])
def test_train_batch_norm(rng, all_masked):
    """Output, running statistics and gradients (features, scale, bias) of
    one train-mode BN against flax; with no valid voxel cnt clamps to 1."""
    b, c, f = 3, 50, 8
    feats = rng.standard_normal((b, c, f)).astype(np.float32) * 2 + 0.5
    mask = rng.random((b, c)) < 0.7
    if all_masked:
        mask[:] = False
    feats = feats * mask[..., None]
    w = rng.standard_normal((b, c, f)).astype(np.float32)
    mean0 = rng.normal(0, 0.2, f).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, f).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bias = rng.normal(0, 0.3, f).astype(np.float32)

    bn = jnorm.SparseBatchNorm(f)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def j_loss(x, params):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          x, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (gx_j, gp_j) = jax.value_and_grad(j_loss, argnums=(0, 1),
                                                           has_aux=True)(
        jnp.asarray(feats), variables["params"])

    t_bn = SparseBatchNorm(f).train()
    with torch.no_grad():
        t_bn.scale.copy_(torch.from_numpy(scale))
        t_bn.bias.copy_(torch.from_numpy(bias))
        t_bn.mean.copy_(torch.from_numpy(mean0))
        t_bn.var.copy_(torch.from_numpy(var0))
    x = torch.from_numpy(feats).requires_grad_()
    y = t_bn(x, torch.from_numpy(mask))
    (y * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_bn.mean.numpy(), np.asarray(stats_j["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_bn.var.numpy(), np.asarray(stats_j["var"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_bn.scale.grad.numpy(), np.asarray(gp_j["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(t_bn.bias.grad.numpy(), np.asarray(gp_j["bias"]), rtol=1e-4,
                               atol=1e-5)
    if not all_masked:
        assert not np.allclose(t_bn.mean.numpy(), mean0)
    # eval mode reads the running statistics and leaves them alone
    t_bn.eval()
    with torch.no_grad():
        y_eval = t_bn(x, torch.from_numpy(mask))
    y_eval_j = bn.apply({"params": variables["params"], "batch_stats": stats_j},
                        jnp.asarray(feats), jnp.asarray(mask), False)
    np.testing.assert_allclose(y_eval.numpy(), np.asarray(y_eval_j), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# kmap_down
# ---------------------------------------------------------------------------

def test_kmap_down_bit_equal(pyramids):
    jp, tp, tspec = pyramids
    assert tp[0].kmap_down is None
    for l in range(1, tspec.num_levels + 1):
        a, b = np.asarray(jp[l].kmap_down), tp[l].kmap_down.numpy()
        assert a.shape == b.shape == (2, 8, tspec.capacities[l]) and b.dtype == np.int32, l
        np.testing.assert_array_equal(a, b, err_msg=f"L{l} kmap_down")
        assert tp[l].kmap_down.is_contiguous(), l  # the CUDA kernels take it as it is
        assert int((b < tspec.capacities[l - 1]).sum()) >= int(tp[l].mask.sum()), l


def test_kmap_down_only_when_asked(pyramids):
    _, tp, tspec = pyramids
    plain = tpyr.build_pyramid(tp[0].coords, tp[0].mask, tspec,
                               keys0=pack_keys(tp[0].coords, tp[0].mask, tspec.pack))
    assert all(plain[l].kmap_down is None for l in range(tspec.num_levels + 1))
    for l in range(tspec.num_levels + 1):
        assert torch.equal(plain[l].kmap_self, tp[l].kmap_self)


# ---------------------------------------------------------------------------
# custom-gradient convs
# ---------------------------------------------------------------------------

def _arr(rng, shape, scale=1.0, mask=None):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if mask is not None:
        x = x * np.asarray(mask)[..., None]
    return x


def _torch_vjp(fn, inputs, g):
    """(out, grads of inputs that require them) of fn for the cotangent g."""
    xs = [torch.from_numpy(x).requires_grad_() if x.dtype == np.float32 else
          torch.from_numpy(x) for x in inputs]
    out = fn(*xs)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in xs if x.requires_grad]


@pytest.mark.parametrize("level,f_in,f_out", [(1, 32, 64), (2, 64, 128), (3, 128, 128)])
def test_sparse_conv_sym_vjp(pyramids, rng, level, f_in, f_out):
    jp, tp, _ = pyramids
    lvl = tp[level]
    kmap = lvl.kmap_self.numpy()
    feats = _arr(rng, (2, lvl.capacity, f_in), mask=lvl.mask)
    kernel = _arr(rng, (27, f_in, f_out), 1 / np.sqrt(27 * f_in))
    g = _arr(rng, (2, lvl.capacity, f_out), mask=lvl.mask)
    out_j, vjp = jax.vjp(lambda x, w: jconv.sparse_conv_sym(x, jnp.asarray(kmap), w),
                         jnp.asarray(feats), jnp.asarray(kernel))
    dx_j, dw_j = vjp(jnp.asarray(g))
    out_t, (dx_t, dw_t) = _torch_vjp(tconv.sparse_conv_sym, (feats, kmap, kernel), g)
    _close(out_t, out_j, "out")
    _close(dx_t, dx_j, "dX")
    _close(dw_t, dw_j, "dW")
    # the same gradients as autograd through the plain forward
    _, (dx_p, dw_p) = _torch_vjp(kernels.gather_conv_plain, (feats, kmap, kernel), g)
    _close(dx_t, dx_p, "dX vs autograd")
    _close(dw_t, dw_p, "dW vs autograd")


@pytest.mark.parametrize("level,f", [(1, 32), (3, 64), (5, 128)])
def test_sparse_conv_down_vjp(pyramids, rng, level, f):
    """The down conv into `level` from level - 1."""
    jp, tp, _ = pyramids
    fine, coarse = tp[level - 1], tp[level]
    args = [coarse.kmap_down.numpy(), fine.up_parent.numpy(), fine.up_koffset.numpy()]
    feats = _arr(rng, (2, fine.capacity, f), mask=fine.mask)
    kernel = _arr(rng, (8, f, f), 1 / np.sqrt(8 * f))
    g = _arr(rng, (2, coarse.capacity, f), mask=coarse.mask)
    out_j, vjp = jax.vjp(lambda x, w: jconv.sparse_conv_down(x, *map(jnp.asarray, args), w),
                         jnp.asarray(feats), jnp.asarray(kernel))
    dx_j, dw_j = vjp(jnp.asarray(g))
    out_t, (dx_t, dw_t) = _torch_vjp(tconv.sparse_conv_down, (feats, *args, kernel), g)
    _close(out_t, out_j, "out")
    _close(dx_t, dx_j, "dX")
    _close(dw_t, dw_j, "dW")
    _, (dx_p, dw_p) = _torch_vjp(lambda x, km, up, ko, w: kernels.gather_conv_plain(x, km, w),
                                 (feats, *args, kernel), g)
    _close(dx_t, dx_p, "dX vs autograd")
    _close(dw_t, dw_p, "dW vs autograd")


@pytest.mark.parametrize("level,f_in,f_out", [(3, 64, 64), (5, 128, 128), (4, 128, 64)])
def test_sparse_tconv2x2_vjp(pyramids, rng, level, f_in, f_out):
    """The transposed conv from `level` + 1 onto `level`."""
    jp, tp, _ = pyramids
    fine, coarse = tp[level], tp[level + 1]
    args = [fine.up_parent.numpy(), fine.up_koffset.numpy(), coarse.kmap_down.numpy()]
    feats = _arr(rng, (2, coarse.capacity, f_in), mask=coarse.mask)
    kernel = _arr(rng, (8, f_in, f_out), 1 / np.sqrt(8 * f_in))
    g = _arr(rng, (2, fine.capacity, f_out), mask=fine.mask)
    out_j, vjp = jax.vjp(lambda x, w: jconv.sparse_tconv2x2_vjp(x, *map(jnp.asarray, args), w),
                         jnp.asarray(feats), jnp.asarray(kernel))
    dx_j, dw_j = vjp(jnp.asarray(g))
    out_t, (dx_t, dw_t) = _torch_vjp(tconv.sparse_tconv2x2_vjp, (feats, *args, kernel), g)
    _close(out_t, out_j, "out")
    _close(dx_t, dx_j, "dX")
    _close(dw_t, dw_j, "dW")
    _, (dx_p, dw_p) = _torch_vjp(lambda x, up, ko, km, w: tconv.sparse_tconv2x2(x, up, ko, w),
                                 (feats, *args, kernel), g)
    _close(dx_t, dx_p, "dX vs autograd")
    _close(dw_t, dw_p, "dW vs autograd")


def test_inference_convs_refuse_gradients(pyramids, rng):
    lvl = pyramids[1][1]
    feats = torch.from_numpy(_arr(rng, (2, lvl.capacity, 32))).requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        tconv.sparse_conv(feats, lvl.kmap_self, torch.zeros(27, 32, 32))
    with torch.no_grad():
        tconv.sparse_conv(feats, lvl.kmap_self, torch.zeros(27, 32, 32))


# ---------------------------------------------------------------------------
# gather_dw's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,level,f_in,f_out", [("self", 1, 32, 64), ("down", 2, 64, 64),
                                                   ("self", 3, 128, 128)])
def test_gather_dw_plain_matches_jax(pyramids, rng, kind, level, f_in, f_out):
    _, tp, _ = pyramids
    kmap = (tp[level].kmap_self if kind == "self" else tp[level].kmap_down).numpy()
    src = tp[level] if kind == "self" else tp[level - 1]
    feats = _arr(rng, (2, src.capacity, f_in), mask=src.mask)
    g = _arr(rng, (2, kmap.shape[2], f_out), mask=tp[level].mask)
    got = kernels.gather_dw_plain(torch.from_numpy(feats), torch.from_numpy(kmap),
                                  torch.from_numpy(g))
    want = jconv._conv_dkernel_gather(jnp.asarray(feats), jnp.asarray(kmap), jnp.asarray(g))
    _close(got.numpy(), want, kind)


def _bf16(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("kind", ["self", "down"])
def test_gather_dw_plain_matches_pallas_interpret(pyramids, rng, kind):
    """Against the Pallas dW kernel in interpret mode, which multiplies in
    bf16: the port's plain version on bf16-rounded operands within the
    bf16 tolerance of tests/test_banded.py (3e-2 of max |want|)."""
    _, tp, _ = pyramids
    lvl = tp[1]
    kmap = (lvl.kmap_self if kind == "self" else lvl.kmap_down).numpy()
    c_in = lvl.capacity if kind == "self" else tp[0].capacity
    feats = _arr(rng, (2, c_in, 16))
    g = _arr(rng, (2, lvl.capacity, 24))
    got = banded_conv_dw(jnp.asarray(feats), jnp.asarray(kmap), jnp.asarray(g), interpret=True)
    assert got is not None
    want = kernels.gather_dw_plain(torch.from_numpy(_bf16(feats)), torch.from_numpy(kmap),
                                   torch.from_numpy(_bf16(g))).numpy()
    err = float(np.abs(np.asarray(got) - want).max())
    assert err / float(np.abs(want).max()) < 3e-2, err
