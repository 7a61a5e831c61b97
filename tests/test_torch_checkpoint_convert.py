"""Port vs JAX: the reference checkpoint converter
(`egonn_tpu_torch/utils/checkpoint_convert.py`).

Mirrors tests/test_checkpoint_convert.py: the ME kernel-offset permutation
against a golden transcription of ME's region order (k = 2/3/4/5) and
JAX's; the two directional checks through the port's pyramid (the odd one
through the stem map, the even one through the lookup-built kmap_down); and
synthetic reference-layout state dicts of EgoNN and MinkLoc3D, written by
inverting JAX-initialised variables, saved with torch.save and read back
by `load_reference_checkpoint`.  The converted trees equal JAX's converter's
and the original variables bit for bit; the port's outputs on the converted
weights equal JAX's on the original ones within the tolerances of
tests/test_torch_model.py (EgoNN `global` rel 1e-4) and
tests/test_torch_minkloc.py (MinkLoc3D `global` rel 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu.models.factory import create_egonn_model as j_create_egonn_model
from egonn_tpu.models.factory import model_factory as j_factory
from egonn_tpu.ops.quantization import CartesianQuantizer as JCartesian
from egonn_tpu.ops.quantization import PolarQuantizer as JPolar
from egonn_tpu.sparse.pyramid import build_pyramid as j_build_pyramid
from egonn_tpu.utils import checkpoint_convert as jconv
from egonn_tpu_torch import inference
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model, model_factory
from egonn_tpu_torch.ops.quantization import CartesianQuantizer, PolarQuantizer
from egonn_tpu_torch.sparse import conv as sconv
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.utils import checkpoint_convert as tconv
from egonn_tpu_torch.utils.weights import load_flax_variables


def me_region_offsets(k):
    """Golden fixture, transcribed independently of me_offset_permutation
    from ME's region semantics: odd k walks the centred cube x fastest, even
    k walks [0, k)^3 z fastest."""
    if k % 2 == 1:
        r = k // 2
        return [(dx, dy, dz) for dz in range(-r, r + 1) for dy in range(-r, r + 1)
                for dx in range(-r, r + 1)]
    return [(dx, dy, dz) for dx in range(k) for dy in range(k) for dz in range(k)]


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_me_offset_permutation_goldens(k):
    p = tconv.me_offset_permutation(k)
    assert sorted(p.tolist()) == list(range(k ** 3))
    np.testing.assert_array_equal(p, jconv.me_offset_permutation(k))
    me, ours = me_region_offsets(k), tpyr.kernel_offsets(k)
    for j in range(k ** 3):
        assert tuple(ours[j]) == me[p[j]], (k, j)


def test_offset_permutation_k3_known_entries():
    p = tconv.me_offset_permutation(3)
    assert (p[0], p[1], p[3]) == (0, 9, 3)


def _one_cloud(points, cap):
    coords = np.zeros((1, 3, cap), np.int32)
    coords[0, :, :len(points)] = np.asarray(points).T
    mask = np.zeros((1, cap), bool)
    mask[0, :len(points)] = True
    return torch.from_numpy(coords), torch.from_numpy(mask)


def test_me_odd_kernel_slots_directional():
    """ME slots of (0,0,0), (+1,0,0) and (0,0,+1) in a k=5 kernel act, after
    conversion, on the voxel itself, its +x and its +z neighbour, through the
    port's stem map (sparse_conv_ones)."""
    k, r, f, cap = 5, 2, 4, 128
    w_center, w_px, w_pz = np.eye(f, dtype=np.float32)[:3]
    me_kernel = np.zeros((k ** 3, 1, f), np.float32)

    def me_idx(dx, dy, dz):
        return (dx + r) + (dy + r) * k + (dz + r) * k * k

    me_kernel[me_idx(0, 0, 0), 0] = w_center
    me_kernel[me_idx(1, 0, 0), 0] = w_px
    me_kernel[me_idx(0, 0, 1), 0] = w_pz
    ours = torch.from_numpy(tconv._conv({"kernel": me_kernel}, "kernel", k))
    coords, mask = _one_cloud([(5, 5, 5), (6, 5, 5), (5, 5, 6)], cap)
    spec = tpyr.PyramidSpec(capacities=(cap, cap), conv0_kernel_size=5)
    pyr = tpyr.build_pyramid(coords, mask, spec)
    out = sconv.sparse_conv_ones(pyr[0].kmap_self, ours, cap).numpy()
    rows = {tuple(c): i for i, c in enumerate(pyr[0].coords[0].T[:3].tolist())}
    a, b, c = rows[(5, 5, 5)], rows[(6, 5, 5)], rows[(5, 5, 6)]
    np.testing.assert_allclose(out[0, a], w_center + w_px + w_pz, atol=1e-6)
    np.testing.assert_allclose(out[0, b], w_center, atol=1e-6)
    np.testing.assert_allclose(out[0, c], w_center, atol=1e-6)


def test_me_even_kernel_slots_directional():
    """Children (4,6,7) and (5,7,6) of parent (2,3,3) sit at ME/our slots 1
    and 6 of the k=2 s=2 kernel: converted weights act on them through the
    lookup-built kmap_down (no up maps recorded)."""
    f_in, f_out, cap = 2, 4, 128
    me_kernel = np.zeros((8, f_in, f_out), np.float32)
    w_a, w_b = np.array([3.0, 0, 1, 0], np.float32), np.array([0, 5.0, 0, 2], np.float32)
    me_kernel[1, 0] = w_a
    me_kernel[6, 1] = w_b
    ours = torch.from_numpy(tconv._conv({"kernel": me_kernel}, "kernel", 2))
    coords, mask = _one_cloud([(4, 6, 7), (5, 7, 6)], cap)
    spec = tpyr.PyramidSpec(capacities=(cap, cap), conv0_kernel_size=5)
    pyr = tpyr.build_pyramid(coords, mask, spec)
    assert pyr[0].up_parent is None and pyr[1].kmap_down is not None
    rows = {tuple(c): i for i, c in enumerate(pyr[0].coords[0].T[:2].tolist())}
    feats = torch.zeros(1, cap, f_in)
    feats[0, rows[(4, 6, 7)], 0] = 1.0
    feats[0, rows[(5, 7, 6)], 1] = 1.0
    out = sconv.sparse_conv(feats, pyr[1].kmap_down, ours).numpy()
    assert int(pyr[1].mask[0].sum()) == 1 and tuple(pyr[1].coords[0, :, 0].tolist()) == (2, 3, 3)
    np.testing.assert_allclose(out[0, 0], w_a + w_b, atol=1e-6)


# ---------------------------------------------------------------------------
# synthetic reference state dicts
# ---------------------------------------------------------------------------

class _Inverse:
    """Writes a reference-layout state dict from flax variables."""

    def __init__(self):
        self.sd = {}

    def conv(self, name, kernel):
        kernel = np.asarray(kernel)
        if kernel.ndim == 3:
            perm = tconv.me_offset_permutation(round(kernel.shape[0] ** (1 / 3)))
            kernel = kernel[np.argsort(perm)]
        self.sd[name] = kernel

    def bn(self, prefix, p, s):
        for ref, v in (("weight", p["scale"]), ("bias", p["bias"]),
                       ("running_mean", s["mean"]), ("running_var", s["var"])):
            self.sd[f"{prefix}.bn.{ref}"] = np.asarray(v)

    def block(self, prefix, p, s):
        for i in (1, 2):
            self.conv(f"{prefix}.conv{i}.kernel", p[f"conv{i}"]["kernel"])
            self.bn(f"{prefix}.norm{i}", p[f"norm{i}"], s[f"norm{i}"])
        if "eca" in p:
            self.sd[f"{prefix}.eca.conv.weight"] = np.asarray(p["eca"]["conv"])[None, None]
        if "downsample_conv" in p:
            self.conv(f"{prefix}.downsample.0.kernel", p["downsample_conv"]["kernel"])
            self.bn(f"{prefix}.downsample.1", p["downsample_norm"], s["downsample_norm"])

    def linear(self, prefix, lin):
        self.sd[f"{prefix}.weight"] = np.asarray(lin["weight"]).T
        self.sd[f"{prefix}.bias"] = np.asarray(lin["bias"])


def _egonn_state_dict(variables):
    inv, p, s = _Inverse(), variables["params"], variables["batch_stats"]
    tp, ts = p["trunk"], s["trunk"]
    inv.conv("trunk.convs.0.kernel", tp["conv0"]["kernel"])
    inv.bn("trunk.bn.0", tp["bn0"], ts["bn0"])
    for i in range(1, 8):
        inv.conv(f"trunk.convs.{i}.kernel", tp[f"conv{i}"]["kernel"])
        inv.bn(f"trunk.bn.{i}", tp[f"bn{i}"], ts[f"bn{i}"])
        inv.block(f"trunk.blocks.{i}.0", tp[f"block{i}_0"], ts[f"block{i}_0"])
    for head, levels in (("global_head", (5, 6, 7)), ("local_head", (3, 4))):
        for lvl in levels:
            inv.conv(f"{head}.conv1x1.{lvl}.kernel", p[head][f"conv1x1_{lvl}"]["kernel"])
        for lvl in range(min(levels) + 1, max(levels) + 1):
            inv.conv(f"{head}.tconv.{lvl}.kernel", p[head][f"tconv_{lvl}"]["kernel"])
    for mod in ("global_descriptor_decoder", "local_descriptor_decoder",
                "local_keypoint_regressor", "local_sigma_regressor"):
        inv.linear(f"{mod}.net.0.linear", p[mod]["fc1"])
        inv.linear(f"{mod}.net.2.linear", p[mod]["fc2"])
    inv.sd["global_pooling.pooling.p"] = np.asarray(p["global_pooling"]["gem"]["p"])
    return inv.sd


def _minkloc3d_state_dict(variables):
    inv = _Inverse()
    bp, bs = variables["params"]["backbone"], variables["batch_stats"]["backbone"]
    inv.conv("backbone.conv0.kernel", bp["conv0"]["kernel"])
    inv.bn("backbone.bn0", bp["bn0"], bs["bn0"])
    for i in range(3):
        inv.conv(f"backbone.convs.{i}.kernel", bp[f"conv{i + 1}"]["kernel"])
        inv.bn(f"backbone.bn.{i}", bp[f"bn{i + 1}"], bs[f"bn{i + 1}"])
        inv.block(f"backbone.blocks.{i}.0", bp[f"block{i + 1}_0"], bs[f"block{i + 1}_0"])
    for j in range(2):
        inv.conv(f"backbone.conv1x1.{j}.kernel", bp[f"conv1x1_{j}"]["kernel"])
    inv.conv("backbone.tconvs.0.kernel", bp["tconv0"]["kernel"])
    inv.sd["pooling.p"] = np.asarray(variables["params"]["pooling"]["gem"]["p"])
    return inv.sd


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _clouds(n):
    """tests/test_torch_model.py's clouds: uniform in angle and range, so no
    point lies within an ulp of a polar cell edge (trap C1: each side
    quantizes on its own)."""
    rng = np.random.default_rng(4)
    theta = rng.uniform(0, 2 * np.pi, (2, n))
    r = rng.uniform(2, 60, (2, n))
    z = rng.uniform(-2, 8, (2, n))
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)


class _MP:
    def __init__(self, model, quantizer, cap0):
        self.model, self.quantizer, self.cap0 = model, quantizer, cap0


CASES = {
    # model, JAX quantizer, port quantizer, cap0, points, global rel tolerance
    "egonn": ("egonn", JPolar([2.0, 1.0, 0.5]), PolarQuantizer([2.0, 1.0, 0.5]), 512, 2048,
              1e-4),
    "MinkLoc3D": ("MinkLoc3D", JCartesian(0.3), CartesianQuantizer(0.3), 8192, 1024, 1e-5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_roundtrip_and_forward(case, tmp_path):
    model, jq, tq, cap0, n, tol = CASES[case]
    built_j = (j_create_egonn_model(_MP(model, jq, cap0), cap0=cap0) if model == "egonn"
               else j_factory(_MP(model, jq, cap0), cap0=cap0))
    spec = built_j.pyramid_spec
    clouds = _clouds(n) if model == "egonn" else lidar_scan_clouds(2, n, seed=4)
    mask = np.ones(clouds.shape[:2], bool)

    @jax.jit
    def mk_pyr(c, m):
        res = jax.vmap(lambda pc, mm: jq.quantize(pc, mm, spec.capacities[0],
                                                  need_index=False))(c, m)
        return j_build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)

    pyr = mk_pyr(jnp.asarray(clouds), jnp.asarray(mask))
    variables = jax.device_get(jax.jit(
        lambda k, p: built_j.model.init(k, p, jq, train=False))(jax.random.PRNGKey(0), pyr))
    sd = (_egonn_state_dict if model == "egonn" else _minkloc3d_state_dict)(variables)
    path = tmp_path / f"synthetic_{model}.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)

    converted = tconv.load_reference_checkpoint(str(path), model=model)
    _assert_trees_equal(converted, variables)
    _assert_trees_equal(converted, jconv.load_reference_checkpoint(str(path), model=model))

    want = np.asarray(jax.jit(lambda v, p: built_j.model.apply(v, p, jq, train=False))(
        variables, pyr)["global"])
    built_t = (create_egonn_model(_MP(model, tq, cap0), cap0=cap0, device="cpu")
               if model == "egonn" else model_factory(_MP(model, tq, cap0), cap0=cap0,
                                                      device="cpu"))
    load_flax_variables(built_t.model, converted)
    got = inference.forward(built_t, torch.from_numpy(clouds), torch.from_numpy(mask))
    got = got["global"].numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= tol, rel
