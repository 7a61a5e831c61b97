"""Port vs JAX: the MinkLoc family (`models/minkloc.py`, `senet.py`,
`netvlad.py`, `resnet.py`, `factory.py::model_factory`) in eval mode.

Each JAX model is built by its own factory (or directly, for ResNetBase)
and initialised; its variables, with every BatchNorm's statistics and
affine perturbed (NetVLAD's unmasked flax BatchNorms too), move into the
port with load_flax_variables, and both sides run the same clouds.  The
port runs each MinkLoc twice: on its factory pyramid (every level records
its up map, down convs in transposed form) and, where the top-down steps
allow, on a pyramid that records only the up maps they need, so the other
down convs gather over lookup-built maps.  Those two runs are bit-equal on
the CPU: the maps are equal and the same gather code runs.

Tolerance: `global` within max abs error 1e-5 x max |JAX| (f32 on both
sides; three levels of convs, GeM's cube / cube root or NetVLAD's softmax
and normalisations in another summation order); ResNetBase's level
outputs the same.  Integer maps bit-equal."""
import dataclasses
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.config import ModelParams as JModelParams
from egonn_tpu.models.factory import model_factory as j_factory
from egonn_tpu.models.resnet import ResNetBase as JResNetBase
from egonn_tpu.ops.quantization import CartesianQuantizer as JCartesian
from egonn_tpu.sparse import pyramid as jpyr
from egonn_tpu_torch import inference
from egonn_tpu_torch.config import ModelParams
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import model_factory
from egonn_tpu_torch.models.resnet import ResNetBase
from egonn_tpu_torch.ops.quantization import CartesianQuantizer
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.utils.weights import load_flax_variables

REL_TOL = 1e-5
CAP0 = 8192  # 1,024 sparse points barely merge from level to level
CONFIG = "model_configs/minkloc3d_mulran.txt"


def _params(quantizer, **kw):
    base = dict(model="MinkFPN", cap0=CAP0, planes=[32, 64, 64], layers=[1, 1, 1],
                num_top_down=1, conv0_kernel_size=5, block="ECABasicBlock", pooling="GeM",
                feature_size=256, output_dim=256)
    base.update(kw)
    return types.SimpleNamespace(quantizer=quantizer, **base)


CASES = {
    # the published config file, parsed by each side's ModelParams
    "minkloc3d_mulran": None,
    "MinkLoc3D_frozen": dict(model="MinkLoc3D"),
    "full_topdown": dict(model="MinkLoc", num_top_down=3, block="BasicBlock", layers=[1, 2, 1]),
    "SEBasicBlock": dict(block="SEBasicBlock", num_top_down=2, pooling="MAC",
                         feature_size=128, output_dim=128),
    "netvlad": dict(pooling="netvlad", feature_size=64, output_dim=128, planes=[32, 32, 64]),
    "netvladgc": dict(pooling="netvladgc", feature_size=64, output_dim=32, num_top_down=0),
}


def _clouds(seed, b=2, n=1024):
    """`lidar_sim` scans cut to 1,024 points, the second padded from 800."""
    clouds = lidar_scan_clouds(b, n, seed=seed)
    mask = np.ones((b, n), bool)
    mask[1, 800:] = False
    return clouds, mask


def _perturb_bn(variables, rng):
    """Random running statistics and affines for every BatchNorm."""
    v = jax.tree_util.tree_map(np.array, flax.core.unfreeze(variables))

    def walk(params, stats):
        for name, sub in params.items():
            if not isinstance(sub, dict):
                continue
            if set(sub) == {"scale", "bias"}:
                f = sub["scale"].shape[0]
                sub["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.2, f).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.2, f).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
            elif name in stats:
                walk(sub, stats[name])

    walk(v["params"], v["batch_stats"])
    return v


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_minkloc_matches_jax(case):
    kw = CASES[case]
    if kw is None:
        mp_j, mp_t = JModelParams(CONFIG), ModelParams(CONFIG)
        assert mp_t.quantizer.quant_step == mp_j.quantizer.quant_step == 0.3
    else:
        mp_j, mp_t = _params(JCartesian(0.3), **kw), _params(CartesianQuantizer(0.3), **kw)
    built_j = j_factory(mp_j, cap0=CAP0)
    built_t = model_factory(mp_t, cap0=CAP0, device="cpu")
    spec, q = built_j.pyramid_spec, built_j.quantizer
    fields = ("capacities", "conv0_kernel_size", "block_kernel_size", "self_levels",
              "up_levels", "need_source_index", "conv0_ones")
    assert [getattr(built_t.pyramid_spec, f) for f in fields] == [getattr(spec, f) for f in fields]
    assert built_t.model_type == built_j.model_type == "minkloc"
    clouds, mask = _clouds(1)

    @jax.jit
    def mk_pyr(c, m):
        res = jax.vmap(lambda pc, mm: q.quantize(pc, mm, spec.capacities[0],
                                                 need_index=False))(c, m)
        return jpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)

    pyr = mk_pyr(jnp.asarray(clouds), jnp.asarray(mask))
    variables = jax.jit(lambda k, p: built_j.model.init(k, p, q, train=False))(
        jax.random.PRNGKey(0), pyr)
    variables = _perturb_bn(variables, np.random.default_rng(2))
    want = np.asarray(jax.jit(lambda v, p: built_j.model.apply(v, p, q, train=False))(
        variables, pyr)["global"])

    load_flax_variables(built_t.model, variables)
    ct, mt = torch.from_numpy(clouds), torch.from_numpy(mask)
    got = inference.forward(built_t, ct, mt)
    assert set(got) == {"global"}
    got = got["global"].numpy()
    assert got.shape == want.shape == (2, mp_t.output_dim if kw else 256)
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-3
    assert _rel(got, want) <= REL_TOL, _rel(got, want)

    # the same model over lookup-built down maps where no top-down step
    # needs the up map
    nb, ntd = len(built_t.model.backbone.layers), built_t.model.backbone.num_top_down
    if ntd < nb:
        lookup_spec = dataclasses.replace(built_t.pyramid_spec,
                                          up_levels=tuple(range(nb - ntd, nb)))
        got2 = inference.forward(dataclasses.replace(built_t, pyramid_spec=lookup_spec), ct, mt)
        np.testing.assert_array_equal(got2["global"].numpy(), got)


def test_minkloc_capacity_fits():
    """The test clouds fit every level, so no comparison rests on drops."""
    built_t = model_factory(ModelParams(CONFIG), cap0=CAP0, device="cpu")
    spec = built_t.pyramid_spec
    clouds, mask = _clouds(1)
    res = built_t.quantizer.quantize(torch.from_numpy(clouds), torch.from_numpy(mask),
                                     spec.capacities[0], need_index=False)
    pyr = tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
    report = tpyr.capacity_report(pyr, spec)
    assert all(ok for _, _, ok in report.values()), report


def test_model_factory_dispatch_and_defaults():
    import inspect

    from egonn_tpu_torch.models import factory

    for fn in (factory.model_factory, factory.create_minkloc_model):
        assert torch.device(inspect.signature(fn).parameters["device"].default) == \
            torch.device("cuda")
    q = CartesianQuantizer(0.3)
    assert model_factory(_params(q, model="egonn"), device="cpu").model_type == "egonn"
    a = model_factory(_params(q), cap0=40960, device="cpu", seed=3)
    b = model_factory(_params(q), cap0=40960, device="cpu", seed=3)
    assert a.pyramid_spec.capacities == (40960, 20480, 10240, 5120)
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    with pytest.raises(NotImplementedError):
        model_factory(_params(q, model="PointNetVLAD"), device="cpu")
    with pytest.raises(NotImplementedError):
        model_factory(_params(q, pooling="GeMx"), device="cpu")


def _resnet_case(block, in_channels, k0):
    """ResNetBase (narrow widths) on JAX and on the port from the same flax
    variables, BN perturbed, over one pyramid with no up maps (every down
    conv gathers over a lookup-built kmap_down) and real level-0 features
    (the stem map holds positions: conv0_ones False)."""
    rng = np.random.default_rng(0)
    cap = 128
    coords = rng.integers(-4, 5, size=(1, 3, cap)).astype(np.int32)
    mask = np.ones((1, cap), bool)
    kw = dict(capacities=(cap,) * 5, conv0_kernel_size=k0, self_levels=(1, 2, 3, 4),
              up_levels=())
    jspec, tspec = jpyr.PyramidSpec(**kw), tpyr.PyramidSpec(**kw)
    pyr = jax.jit(lambda c, m: jpyr.build_pyramid(c, m, jspec))(jnp.asarray(coords),
                                                                 jnp.asarray(mask))
    tp = tpyr.build_pyramid(torch.from_numpy(coords), torch.from_numpy(mask), tspec)
    for l in range(5):
        np.testing.assert_array_equal(tp[l].kmap_self.numpy(), np.asarray(pyr[l].kmap_self))
        if l:
            np.testing.assert_array_equal(tp[l].kmap_down.numpy(), np.asarray(pyr[l].kmap_down))
    feats0 = (rng.standard_normal((1, cap, in_channels)) * np.asarray(pyr[0].mask)[..., None]
              ).astype(np.float32)
    net = JResNetBase(in_channels=in_channels, planes=(8, 16, 16, 32), layers=(1, 1, 1, 1),
                      block=block, conv0_kernel_size=k0, init_dim=8)
    variables = jax.jit(lambda k, p, f: net.init(k, p, f, False))(
        jax.random.PRNGKey(0), pyr, jnp.asarray(feats0))
    variables = _perturb_bn(variables, np.random.default_rng(1))
    want = jax.jit(lambda v, p, f: net.apply(v, p, f, False))(variables, pyr,
                                                               jnp.asarray(feats0))
    model = ResNetBase(in_channels, torch.Generator().manual_seed(0), planes=(8, 16, 16, 32),
                       layers=(1, 1, 1, 1), block=block, conv0_kernel_size=k0,
                       init_dim=8).eval()
    load_flax_variables(model, variables)
    with torch.no_grad():
        got = model(tp, torch.from_numpy(feats0))
    assert set(got) == set(want) == {1, 2, 3, 4}
    for l in got:
        w = np.asarray(want[l])
        assert got[l].shape == w.shape
        assert _rel(got[l].numpy(), w) <= REL_TOL, (l, _rel(got[l].numpy(), w))
    assert np.abs(np.asarray(want[4])).max() > 1e-3


@pytest.mark.parametrize("block", ["BasicBlock", "Bottleneck", "SEBottleneck"])
def test_resnet_matches_jax(block):
    """The spec and shapes of tests/test_resnet.py: 4-channel features, a
    3^3 stem."""
    _resnet_case(block, 4, 3)


@pytest.mark.parametrize("block", ["BasicBlock", "Bottleneck"])
def test_resnet_one_channel_matches_jax(block):
    """in_channels 1 and the 5^3 stem of chip_smoke's ResNet14: the stem's
    F_in = 1, which the card's gather conv takes only through its width
    plan (zero-padded to 4)."""
    _resnet_case(block, 1, 5)


def test_netvlad_train_batch_norm_matches_flax(rng):
    """NetVLADLoupe with context gating in train mode against JAX's on the
    same weights and padded features (every row, padding included, in the
    statistics, as flax's BatchNorm): the output within rel 1e-5, both
    BatchNorms' updated running statistics (flax's momentum 0.99, biased
    variance) within rel 1e-5, and every parameter's gradient of the summed
    output within 1e-4 of its leaf's max."""
    from egonn_tpu.models.netvlad import NetVLADLoupe as JNetVLAD
    from egonn_tpu_torch.models.netvlad import NetVLADLoupe

    b, c, f, k, out = 3, 40, 16, 8, 12
    feats = rng.normal(0, 1, (b, c, f)).astype(np.float32)
    mask = np.ones((b, c), bool)
    mask[1, 25:] = False
    feats[~mask] = 0.0
    model = NetVLADLoupe(f, k, out, torch.Generator().manual_seed(0), gating=True)
    with torch.no_grad():  # running statistics away from their initial values
        for bn in (model.cluster_bn, model.context_gating.bn):
            bn.mean.copy_(torch.from_numpy(rng.normal(0, 0.2, bn.mean.shape).astype(np.float32)))
            bn.var.copy_(torch.from_numpy(rng.uniform(0.5, 2, bn.var.shape).astype(np.float32)))
    tree = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        parts = key.split(".")
        node = tree["batch_stats" if parts[-1] in ("mean", "var") else "params"]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(t.numpy())

    jmodel = JNetVLAD(f, k, out, gating=True)

    def loss(params, x):
        y, mut = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]}, x,
                              jnp.asarray(mask), train=True, mutable=["batch_stats"])
        return y.sum(), (y, mut["batch_stats"])

    (_, (y_j, bs_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tree["params"], jnp.asarray(feats))
    model.train()
    y_t = model(torch.from_numpy(feats), torch.from_numpy(mask))
    y_t.sum().backward()
    assert _rel(y_t.detach().numpy(), np.asarray(y_j)) <= 1e-5
    for name in ("cluster_bn", "context_gating.bn"):
        node = bs_j
        for p in name.split("."):
            node = node[p]
        bn = model.get_submodule(name)
        for stat in ("mean", "var"):
            assert _rel(getattr(bn, stat).numpy(), np.asarray(node[stat])) <= 1e-5, (name, stat)
    for key, p in model.named_parameters():
        node = g_j
        for part in key.split("."):
            node = node[part]
        want = np.asarray(node)
        assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max(), key
