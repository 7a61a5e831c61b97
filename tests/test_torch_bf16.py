"""Port vs JAX: the bf16 accelerator numerics of the serving path.

Under EGONN_BF16_ACTS=1 the JAX package stores the EgoNN trunk's and heads'
activations in bf16 on a TPU, and its Pallas conv kernels multiply bf16
operands into f32 sums.  The port does the same on a CUDA card: on the CPU
its `activation_dtype` (like JAX's) stays f32, so these tests reach the
bf16 path by patching `activation_dtype` on both sides.

Tolerances:
* the bf16 plain versions of gather_conv and tdown against JAX's exact
  gather engine on bf16-rounded features and weights: rtol = atol = 1e-5
  before the final cast (the same f32 sums in another order), and after it
  bit-equal but for sum-order flips of one bf16 ulp (at most 1% of the
  outputs);
* against the Pallas kernel in interpret mode (bf16 in the kernel): 3e-2 of
  max |Pallas|, tests/test_banded.py's bf16 rule;
* SparseBatchNorm on bf16 input: bf16 output within 3e-2 of max |flax|
  (the two frameworks round to bf16 at the same place, but flax's f32
  normalisation may land on the other side of a rounding edge), statistics
  within rel 1e-5;
* the whole MinkGL with `activation_dtype` patched on both sides: every
  output's type JAX's, values within 3e-2 of each output's max |JAX| (the
  CPU reference multiplies bf16 features by f32 weights, the port by
  bf16-rounded weights: ROADMAP C, known difference 24).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.models.minkgl import MinkGL as JMinkGL
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse import banded as jbanded
from egonn_tpu.sparse import conv as jconv
from egonn_tpu.sparse import norm as jnorm
from egonn_tpu.sparse import pyramid as jpyr
from egonn_tpu_torch import inference
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model
from egonn_tpu_torch.models.minkgl import MinkGL
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse import conv as tconv
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.utils.weights import load_flax_variables

BF16_RULE = 3e-2
STEPS = [1.0, 0.3, 0.2]


def _bf16_values(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _to_torch_bf16(x) -> torch.Tensor:
    """A JAX bf16 (or bf16-valued f32) array as a torch bf16 tensor, exactly."""
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def pyr():
    clouds = torch.from_numpy(lidar_scan_clouds(2, 4096, seed=5))
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    spec = tpyr.egonn_pyramid_spec(cap0=1024, num_levels=3)
    res = PolarQuantizer(STEPS).quantize(clouds, mask, spec.capacities[0], need_index=False)
    return tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)


def _epi(rng, f, mask):
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bias = rng.normal(0, 0.3, f).astype(np.float32)
    return ((torch.from_numpy(scale), torch.from_numpy(bias), True, mask),
            (jnp.asarray(scale), jnp.asarray(bias), True, jnp.asarray(mask.numpy())))


def _j_epi(out, epi):
    if epi is None:
        return out
    scale, bias, relu, mask = epi
    out = out * scale + bias
    if relu:
        out = jnp.maximum(out, 0.0)
    return jnp.where(mask[..., None], out, 0.0)


def _hold_plain_bf16(got16, got32, want32):
    """The port's bf16 plain output against JAX's f32 sums on the same
    bf16-rounded inputs: its f32 sums (got32) within rtol = atol = 1e-5,
    the output their one rounding, and JAX's rounded output equal but for
    one-ulp flips on at most 1% of the outputs."""
    assert got16.dtype == torch.bfloat16
    want32 = np.asarray(want32)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=1e-5, atol=1e-5)
    assert torch.equal(got16, got32.to(torch.bfloat16))
    ulps = kernels.bf16_ulps(got16, _to_torch_bf16(jnp.asarray(want32).astype(jnp.bfloat16)))
    assert int(ulps.max()) <= 1
    assert float((ulps > 0).float().mean()) <= 0.01
    assert float(np.abs(want32).max()) > 0.1


def test_activation_dtype(monkeypatch):
    """bf16 only where EGONN_BF16_ACTS=1 and the device is a CUDA card (JAX:
    only on a TPU); the default is "0"."""
    monkeypatch.delenv("EGONN_BF16_ACTS", raising=False)
    for device in ("cpu", "cuda", torch.device("cuda", 0)):
        assert tconv.activation_dtype(device) == torch.float32
    monkeypatch.setenv("EGONN_BF16_ACTS", "1")
    assert tconv.activation_dtype("cpu") == torch.float32
    assert tconv.activation_dtype(torch.device("cuda", 0)) == torch.bfloat16
    assert jconv.activation_dtype() == jnp.float32  # JAX on the CPU: off the TPU


def test_bf16_kernel_rules():
    """The bf16 kernels take F_in in multiples of 8 (a 16-byte row piece),
    the plan pads to them, and every streaming tdown tiling fits."""
    for f in range(0, 140):
        assert kernels.conv_widths_ok(f, 32, bf16=True) == (f % 8 == 0 and 8 <= f <= 128)
    assert kernels.conv_widths_ok(160, 64, bf16=True)
    assert not kernels.conv_widths_ok(4, 32, bf16=True)
    assert kernels.width_plan(3, 48, bf16=True)[:2] == (8, 64)
    assert kernels.width_plan(3, 48)[:2] == (4, 64)
    for rows in (32, 64, 128):
        for rc in (32, 64, 128):
            assert kernels.tdown_tiling_ok(128, 128, rows, rc, bf16=True)
    assert not kernels.tdown_tiling_ok(128, 128, 64, 128)


def test_bf16_ulps():
    """Distances in bf16 ulps, across zero and the binades."""
    a = torch.tensor([1.0, 1.0, -1.0, 0.0, 2.0, 3.0], dtype=torch.bfloat16)
    step = torch.tensor([2 ** -7, 0.0, -2 ** -7, 0.0, -2 ** -7, 2 ** -6], dtype=torch.bfloat16)
    b = a + step
    assert kernels.bf16_ulps(a, b).tolist() == [1, 0, 1, 0, 1, 1]
    assert kernels.bf16_ulps(torch.tensor([0.0], dtype=torch.bfloat16),
                             torch.tensor([-0.0], dtype=torch.bfloat16)).tolist() == [0]


@pytest.mark.parametrize("level,f_in,f_out", [(1, 16, 16), (2, 24, 32), (3, 128, 128)])
@pytest.mark.parametrize("with_epi", [False, True])
def test_gather_conv_plain_bf16_matches_jax(pyr, rng, level, f_in, f_out, with_epi):
    lvl = pyr[level]
    feats = _bf16_values(rng.standard_normal((*lvl.mask.shape, f_in)).astype(np.float32)
                         * lvl.mask.numpy()[..., None])
    kernel = (rng.standard_normal((27, f_in, f_out)) / np.sqrt(27 * f_in)).astype(np.float32)
    k16 = _bf16_values(kernel)
    t_epi, j_epi = _epi(rng, f_out, lvl.mask) if with_epi else (None, None)
    got16 = kernels.gather_conv_plain(torch.from_numpy(feats).to(torch.bfloat16),
                                      lvl.kmap_self, torch.from_numpy(kernel), t_epi)
    got32 = kernels.gather_conv_plain(torch.from_numpy(feats), lvl.kmap_self,
                                      torch.from_numpy(k16), t_epi)
    want32 = _j_epi(jbanded._plain_gather_conv(jnp.asarray(feats),
                                               jnp.asarray(lvl.kmap_self.numpy()),
                                               jnp.asarray(k16)), j_epi)
    _hold_plain_bf16(got16, got32, want32)


@pytest.mark.parametrize("level,f_in,f_out", [(0, 16, 16), (1, 24, 32), (2, 128, 128)])
@pytest.mark.parametrize("with_epi", [False, True])
def test_tdown_plain_bf16_matches_jax(pyr, rng, level, f_in, f_out, with_epi):
    fine, coarse = pyr[level], pyr[level + 1]
    feats = _bf16_values(rng.standard_normal((*fine.mask.shape, f_in)).astype(np.float32)
                         * fine.mask.numpy()[..., None])
    kernel = (rng.standard_normal((8, f_in, f_out)) / np.sqrt(8 * f_in)).astype(np.float32)
    k16 = _bf16_values(kernel)
    t_epi, j_epi = _epi(rng, f_out, coarse.mask) if with_epi else (None, None)
    args = (fine.up_parent, fine.up_koffset)
    got16 = kernels.tdown_plain(torch.from_numpy(feats).to(torch.bfloat16), *args,
                                torch.from_numpy(kernel), coarse.capacity, t_epi)
    got32 = kernels.tdown_plain(torch.from_numpy(feats), *args, torch.from_numpy(k16),
                                coarse.capacity, t_epi)
    want32 = _j_epi(jbanded.plain_tdown(jnp.asarray(feats), jnp.asarray(fine.up_parent.numpy()),
                                        jnp.asarray(fine.up_koffset.numpy()), jnp.asarray(k16),
                                        coarse.capacity), j_epi)
    _hold_plain_bf16(got16, got32, want32)


def _pallas_pyramid():
    """tests/test_banded.py's `_real_pyramid` (JAX's quantizer and pyramid)."""
    rng = np.random.default_rng(0)
    b, n = 2, 4096
    theta = rng.uniform(0, 2 * np.pi, (b, n))
    r = np.abs(rng.normal(25, 18, (b, n))).clip(2, 80)
    z = rng.uniform(-1, 10, (b, n))
    clouds = jnp.asarray(np.stack([r * np.cos(theta), r * np.sin(theta), z], -1)
                         .astype(np.float32))
    q = JPolar(STEPS)
    spec = jpyr.egonn_pyramid_spec(cap0=1024, num_levels=3, min_out_level=1)
    res = jax.vmap(lambda pc, mm: q.quantize(pc, mm, spec.capacities[0], need_index=False))(
        clouds, jnp.ones((b, n), bool))
    return jpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)


@pytest.mark.parametrize("case", ["sentinel_rows", "epilogue"])
def test_plain_bf16_matches_pallas_interpret(case):
    """The bf16 plain version against the Pallas conv kernel in interpret
    mode at tests/test_banded.py's non-slow shapes: within 3e-2 of max
    |Pallas| (the kernel's one-hot gather keeps bf16 rows exactly)."""
    rng = np.random.default_rng(1)
    if case == "sentinel_rows":
        b, k, c, f = 1, 8, 256, 8
        kmap = np.full((b, k, c), c, np.int32)
        kmap[:, :, :128] = rng.integers(0, 16, size=(b, k, 128))
        mask, epi = None, None
    else:
        lvl = _pallas_pyramid()[1]
        kmap, mask = np.array(lvl.kmap_self), np.array(lvl.mask)
        b, k, c, f = kmap.shape[0], 27, kmap.shape[2], 16
    feats = rng.standard_normal((b, c, f)).astype(np.float32)
    if mask is not None:
        feats *= mask[..., None]
    kernel = (rng.standard_normal((k, f, f)) * 0.2).astype(np.float32)
    t_epi = j_epi = None
    if mask is not None:
        scale = rng.uniform(0.5, 2.0, f).astype(np.float32)
        bias = rng.standard_normal(f).astype(np.float32)
        t_epi = (torch.from_numpy(scale), torch.from_numpy(bias), True, torch.from_numpy(mask))
        j_epi = (jnp.asarray(scale), jnp.asarray(bias), True, jnp.asarray(mask))
    want = np.asarray(jbanded.banded_conv_pallas(jnp.asarray(feats), jnp.asarray(kmap),
                                                 jnp.asarray(kernel), epi=j_epi,
                                                 interpret=True))
    got = kernels.gather_conv_plain(torch.from_numpy(feats).to(torch.bfloat16),
                                    torch.from_numpy(kmap), torch.from_numpy(kernel), t_epi)
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_RULE * float(np.abs(want).max()), err
    assert float(np.abs(want).max()) > 0.1


@pytest.mark.parametrize("train", [False, True])
def test_sparse_batch_norm_bf16_matches_flax(rng, train):
    """bf16 in, bf16 out; statistics and the normalisation in f32."""
    b, c, f = 2, 300, 24
    mask = rng.random((b, c)) < 0.8
    feats = _bf16_values((rng.standard_normal((b, c, f)) * 2.0 + 0.5).astype(np.float32)
                         * mask[..., None])
    stats = {"mean": rng.normal(0, 0.2, f).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, f).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
              "bias": rng.normal(0, 0.3, f).astype(np.float32)}
    x_j = jnp.asarray(feats).astype(jnp.bfloat16)
    y_j, mut = jnorm.SparseBatchNorm(f).apply({"params": params, "batch_stats": stats}, x_j,
                                              jnp.asarray(mask), train, mutable=["batch_stats"])
    bn = SparseBatchNorm(f).train(train)
    with torch.no_grad():
        for name, v in {**params, **stats}.items():
            getattr(bn, name).copy_(torch.from_numpy(v))
        y = bn(torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(mask))
    assert y.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    want = np.asarray(y_j, dtype=np.float32)
    assert float(np.abs(y.float().numpy() - want).max()) <= BF16_RULE * float(np.abs(want).max())
    assert np.all(y.float().numpy()[~mask] == 0)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(mut["batch_stats"][name]), rtol=1e-5, atol=0)


def _perturb_bn(variables, rng):
    """Random running statistics and affines for every BatchNorm."""
    v = jax.tree_util.tree_map(np.array, flax.core.unfreeze(variables))

    def walk(params, stats):
        for name, sub in params.items():
            if set(sub) == {"scale", "bias"}:
                f = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.2, f).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.2, f).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
            elif isinstance(sub, dict) and name in stats:
                walk(sub, stats[name])

    walk(v["params"], v["batch_stats"])
    return v


_SMALL = dict(trunk_planes=(16, 32, 32), trunk_layers=(1, 1, 1), global_in_levels=(2, 3),
              global_map_channels=32, global_descriptor_size=32, local_in_levels=(1, 2),
              local_map_channels=16, local_descriptor_size=32)


def test_minkgl_bf16_matches_jax(monkeypatch):
    """The whole EgoNN network (3 levels, narrow widths, ECA blocks, a
    width-changing residual, both heads) with bf16 activations on both
    sides from the same weights: every output's type JAX's (f32: the heads'
    Dense layers promote), values within 3e-2 of each output's max."""
    clouds = lidar_scan_clouds(2, 4096, seed=7)
    mask = np.ones(clouds.shape[:2], bool)
    spec_j = jpyr.egonn_pyramid_spec(cap0=1024, num_levels=3, min_out_level=1)
    spec_t = tpyr.egonn_pyramid_spec(cap0=1024, num_levels=3, min_out_level=1)
    qj, qt = JPolar(STEPS), PolarQuantizer(STEPS)
    res = jax.vmap(lambda pc, mm: qj.quantize(pc, mm, spec_j.capacities[0], need_index=False))(
        jnp.asarray(clouds), jnp.asarray(mask))
    pyr_j = jpyr.build_pyramid(res.coords_t, res.mask, spec_j, keys0=res.keys)
    res_t = qt.quantize(torch.from_numpy(clouds), torch.from_numpy(mask), spec_t.capacities[0],
                        need_index=False)
    pyr_t = tpyr.build_pyramid(res_t.coords_t, res_t.mask, spec_t, keys0=res_t.keys)
    for l in range(4):
        np.testing.assert_array_equal(pyr_t[l].mask.numpy(), np.asarray(pyr_j[l].mask))

    model_j = JMinkGL(**_SMALL)
    variables = _perturb_bn(model_j.init(jax.random.PRNGKey(0), pyr_j, qj, train=False),
                            np.random.default_rng(3))
    model_t = MinkGL(gen=torch.Generator().manual_seed(0), **_SMALL).eval()
    load_flax_variables(model_t, variables)

    monkeypatch.setattr(jconv, "activation_dtype", lambda: jnp.bfloat16)
    y_j = model_j.apply(variables, pyr_j, qj, train=False)
    monkeypatch.setattr(tconv, "activation_dtype", lambda device: torch.bfloat16)
    with torch.no_grad():
        trunk = model_t.trunk(pyr_t)
        y_t = model_t(pyr_t, qt)
    assert all(v.dtype == torch.bfloat16 for v in trunk.values())
    assert set(y_t) == set(y_j) == {"global", "descriptors", "keypoints", "sigma", "kp_mask"}
    for k, want in y_j.items():
        got = y_t[k].numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "kp_mask":
            np.testing.assert_array_equal(got, want)
            continue
        assert np.isfinite(got).all(), k
        err = float(np.abs(got - want).max())
        assert err <= BF16_RULE * float(np.abs(want).max()), (k, err)


def test_inference_forward_bf16_host_outputs(monkeypatch):
    """`inference.forward` with bf16 activations returns what the host can
    take: every output converts with .numpy() (f32 and bool, as JAX's), is
    finite and within 3e-2 of the f32 forward's max."""
    from types import SimpleNamespace

    mp = SimpleNamespace(model="egonn", quantizer=PolarQuantizer(STEPS), cap0=1024)
    built = create_egonn_model(mp, cap0=1024, device="cpu", seed=0)
    clouds = torch.from_numpy(lidar_scan_clouds(2, 4096, seed=1))
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    y32 = inference.forward(built, clouds, mask)
    monkeypatch.setattr(tconv, "activation_dtype", lambda device: torch.bfloat16)
    y16 = inference.forward(built, clouds, mask)
    for k, v in y16.items():
        host = v.numpy()
        assert host.dtype == y32[k].numpy().dtype, k
        if k == "kp_mask":
            np.testing.assert_array_equal(host, y32[k].numpy())
            continue
        assert np.isfinite(host).all(), k
        assert float(np.abs(host - y32[k].numpy()).max()) <= BF16_RULE * float(
            np.abs(y32[k].numpy()).max()), k
