"""Port vs JAX: the EgoNN inference forward as a whole.

The JAX model (create_egonn_model at cap0=512, the fixture shape of
tests/test_model.py, quantized with need_index=False and keys0 as bench.py
does) is built and initialised; its variables, with BatchNorm statistics and
affines perturbed so that every BN carries information, move into the port
with load_flax_variables; both sides then run the same clouds."""
import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egonn_tpu.models.factory import create_egonn_model as j_create
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse.pyramid import build_pyramid as j_build_pyramid
from egonn_tpu_torch import inference
from egonn_tpu_torch.models.factory import create_egonn_model as t_create
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.utils.weights import load_flax_variables

STEPS = [2.0, 1.0, 0.5]


class _MP:
    def __init__(self, quantizer):
        self.model = "egonn"
        self.quantizer = quantizer
        self.cap0 = 512


def _synth_cloud(rng, n=2048):
    theta = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(2, 60, n)
    z = rng.uniform(-2, 8, n)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], 1).astype(np.float32)


def _perturb_bn(variables, rng):
    """Random running stats and affines for every BatchNorm (shared by both sides)."""
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


@pytest.fixture(scope="module")
def both():
    built_j = j_create(_MP(JPolar(STEPS)), cap0=512)
    spec, q = built_j.pyramid_spec, built_j.quantizer
    rng = np.random.default_rng(0)
    clouds = np.stack([_synth_cloud(rng) for _ in range(2)])
    mask = np.ones(clouds.shape[:2], bool)

    @jax.jit
    def mk_pyr(c, m):
        res = jax.vmap(lambda pc, mm: q.quantize(pc, mm, spec.capacities[0],
                                                 need_index=False))(c, m)
        return j_build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)

    pyr = mk_pyr(jnp.asarray(clouds), jnp.asarray(mask))
    variables = built_j.model.init(jax.random.PRNGKey(0), pyr, q, train=False)
    variables = _perturb_bn(variables, np.random.default_rng(1))
    y_j = jax.jit(lambda v, p: built_j.model.apply(v, p, q, train=False))(variables, pyr)

    built_t = t_create(_MP(PolarQuantizer(STEPS)), cap0=512, device="cpu")
    load_flax_variables(built_t.model, variables)
    y_t = inference.forward(built_t, torch.from_numpy(clouds), torch.from_numpy(mask))
    return ({k: np.asarray(v) for k, v in y_j.items()},
            {k: v.numpy() for k, v in y_t.items()}, variables, built_t)


def test_output_shapes(both):
    y_j, y_t, _, built_t = both
    assert set(y_t) == set(y_j) == {"global", "descriptors", "keypoints", "sigma", "kp_mask"}
    for k in y_j:
        assert y_t[k].shape == y_j[k].shape and y_t[k].dtype == y_j[k].dtype, k
    assert y_t["global"].shape == (2, 256)
    assert built_t.pyramid_spec.capacities[3] == y_t["descriptors"].shape[1]


def test_global_descriptor(both):
    """Relative max error 1e-4: f32 on both sides, but the trunk's 7 levels of
    27-offset convs, ECA and GeM's cube / cube root compound the ulp-level
    differences of summation order (and of rsqrt / pow between XLA and torch)."""
    y_j, y_t, _, _ = both
    want, got = y_j["global"], y_t["global"]
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-4, rel
    assert np.abs(want).max() > 1e-3


def test_local_head(both):
    """descriptors are unit vectors: atol 1e-4; keypoints are metres at up to
    ~60 m from the sensor: atol 1e-3 m; sigma: rtol 1e-4 (softplus > 0);
    kp_mask is integer logic: bit-equal."""
    y_j, y_t, _, _ = both
    np.testing.assert_array_equal(y_t["kp_mask"], y_j["kp_mask"])
    assert y_t["kp_mask"].sum() > 0
    np.testing.assert_allclose(y_t["descriptors"], y_j["descriptors"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(y_t["keypoints"], y_j["keypoints"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(y_t["sigma"], y_j["sigma"], rtol=1e-4, atol=0)


def test_load_flax_variables_uses_every_leaf(both):
    _, _, variables, built_t = both
    state = built_t.model.state_dict()
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert n_leaves == len(state)
    for key, t in state.items():  # every port tensor holds the flax value
        tree = variables["params"] if key.rsplit(".", 1)[-1] not in ("mean", "var") \
            else variables["batch_stats"]
        for part in key.split("."):
            tree = tree[part]
        np.testing.assert_array_equal(t.numpy(), tree, err_msg=key)

    missing = copy.deepcopy(variables)
    del missing["params"]["trunk"]["conv0"]
    with pytest.raises(ValueError, match="trunk.conv0.kernel"):
        load_flax_variables(built_t.model, missing)
    extra = copy.deepcopy(variables)
    extra["params"]["trunk"]["bn0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="trunk.bn0.extra"):
        load_flax_variables(built_t.model, extra)
    wrong = copy.deepcopy(variables)
    wrong["params"]["trunk"]["bn0"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(built_t.model, wrong)


@pytest.fixture(scope="module")
def head_options(both):
    """The JAX model's head options on the fixture's clouds and variables:
    keypoints at the supervoxel centres with the global head off, and the
    local head off (one jit each)."""
    _, _, variables, built_t = both
    built_j = j_create(_MP(JPolar(STEPS)), cap0=512)
    spec, q = built_j.pyramid_spec, built_j.quantizer
    rng = np.random.default_rng(0)
    clouds = np.stack([_synth_cloud(rng) for _ in range(2)])
    mask = np.ones(clouds.shape[:2], bool)

    def run(model, **flags):
        def fwd(v, c, m):
            res = jax.vmap(lambda pc, mm: q.quantize(pc, mm, spec.capacities[0],
                                                     need_index=False))(c, m)
            pyr = j_build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
            return model.apply(v, pyr, q, train=False, **flags)
        return fwd

    args = (variables, jnp.asarray(clouds), jnp.asarray(mask))
    no_regressor = built_j.model.clone(ignore_keypoint_regressor=True)
    y_kp = jax.jit(run(no_regressor, disable_global_head=True))(*args)
    y_gl = jax.jit(run(built_j.model, disable_local_head=True))(*args)
    y_none = jax.eval_shape(run(built_j.model, disable_global_head=True,
                                disable_local_head=True), *args)
    return ({k: np.asarray(v) for k, v in y_kp.items()},
            {k: np.asarray(v) for k, v in y_gl.items()}, y_none, clouds, mask)


def test_head_options_match_jax(both, head_options):
    """ignore_keypoint_regressor and disable_global_head / disable_local_head
    against JAX, with the tolerances above; a disabled head's keys are
    absent, and both disabled return {} on both sides."""
    _, y_t_full, _, built_t = both
    y_kp, y_gl, y_none, clouds, mask = head_options
    model, quantizer = built_t.model, built_t.quantizer
    c, m = torch.from_numpy(clouds), torch.from_numpy(mask)
    spec = built_t.pyramid_spec
    res = quantizer.quantize(c, m, spec.capacities[0], need_index=False)
    from egonn_tpu_torch.sparse.pyramid import build_pyramid as t_build_pyramid

    pyr = t_build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
    model.ignore_keypoint_regressor = True
    try:
        with torch.no_grad():
            t_kp = {k: v.numpy() for k, v in
                    model(pyr, quantizer, disable_global_head=True).items()}
    finally:
        model.ignore_keypoint_regressor = False
    assert set(t_kp) == set(y_kp) == {"descriptors", "keypoints", "sigma", "kp_mask"}
    np.testing.assert_array_equal(t_kp["kp_mask"], y_kp["kp_mask"])
    np.testing.assert_allclose(t_kp["descriptors"], y_kp["descriptors"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_kp["keypoints"], y_kp["keypoints"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_kp["sigma"], y_kp["sigma"], rtol=1e-4, atol=0)
    # zero offsets: the keypoints moved off the regressed positions to the centres
    assert np.abs(t_kp["keypoints"] - y_t_full["keypoints"]).max() > 1e-2

    t_gl = inference.forward(built_t, c, m, with_local=False)
    assert set(t_gl) == set(y_gl) == {"global"}
    rel = np.abs(t_gl["global"].numpy() - y_gl["global"]).max() / np.abs(y_gl["global"]).max()
    assert rel <= 1e-4, rel
    np.testing.assert_array_equal(t_gl["global"].numpy(), y_t_full["global"])

    with torch.no_grad():
        assert model(pyr, quantizer, disable_global_head=True, disable_local_head=True) == {}
    assert y_none == {}
