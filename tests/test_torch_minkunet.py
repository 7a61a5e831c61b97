"""MinkUNet34C (`models/minkunet.py`) through the port's normal path
(`model_factory`, `inference.forward` with per-point features), held against
the benchmark's plain reference (`benchmark/reference/minkunet.py`) on
seeded random weights (`benchmark/core/weights.py`), and the pieces it
forced: the quantizer's key pack and point -> voxel inverse
(`sparse/packing.py::sorted_unique`), level 0's 3^3 map beside the stem's
5^3 one (`sparse/pyramid.py::_block_map`), the configuration file.

Scans are `benchmark/core/scans.py`'s at a tenth of their size (so that
2,048 points find neighbours at 5 cm), with points planted outside the
pack's x and z range, masked points and, where a case says so, a level-0
capacity below the scan's voxel count (voxels dropped).

Tolerances: integer outputs (keys, maps, the inverse, the point mask)
bit-equal; logits within max abs error 1e-5 x max |reference| a cloud,
f32 on both sides with the same products summed in another order through
34 conv layers (the readings: ~2e-7 at reduced widths, ~1e-6 at the
published ones).  Cases marked `cuda` hold the z-run search and the lookup
on the new pack against their plain versions bit for bit, and the card's
forward at the published widths against the reference at the same 1e-5;
they skip without a card.  This module imports no JAX, so on a machine
with only torch they run with

    python -m pytest tests/test_torch_minkunet.py -m cuda --noconftest -p no:cacheprovider
"""
import dataclasses

import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from benchmark.core import compare, scans, weights
from benchmark.reference import minkunet as ref_minkunet
from benchmark.reference import models as ref_models
from benchmark.reference import sparse as ref_sparse
from egonn_tpu_torch import inference
from egonn_tpu_torch.config import ModelParams
from egonn_tpu_torch.models.factory import model_factory
from egonn_tpu_torch.models.minkunet import MinkUNetBase
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr
from egonn_tpu_torch.sparse.packing import DEFAULT_PACK, MAXKEY, PackSpec

CONFIG = "model_configs/minkunet34c_semantickitti.txt"
PACK = PackSpec((11, 11, 8), (1024, 1024, 128))
REL_TOL = 1e-5
PUBLISHED = dict(init_dim=32, planes=(32, 64, 128, 256, 256, 128, 96, 96),
                 layers=(2, 3, 4, 6, 2, 2, 2, 2))
REDUCED = dict(init_dim=8, planes=(8, 16, 16, 24, 16, 16, 8, 8), layers=(1, 1, 1, 1, 1, 1, 1, 2))


def _scans(b, n, seed=0, device="cpu"):
    """(clouds, mask, feats): scans shrunk tenfold, the first 8 points of
    each moved outside the pack's range (x 60 m, then z 7 m), the next 4
    masked; feats x, y, z, intensity."""
    gen = scans.generator(device, seed, 2)
    clouds = scans.lidar_scans(b, n, gen) * 0.1
    clouds[:, :4, 0] = 60.0
    clouds[:, 4:8, 2] = 7.0
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    mask[:, 8:12] = False
    feats = torch.cat([clouds, torch.rand(b, n, 1, generator=gen, device=device)], -1)
    return clouds, mask, feats


def _built(caps, widths, device="cpu"):
    """The port's MinkUNet through the factory (at `widths`) and the
    reference's, with one seeded state dict loaded into both."""
    params = ModelParams(CONFIG)
    params.capacities = list(caps)
    built = model_factory(params, device=device)
    unet = type("MinkUNet", (MinkUNetBase,), dict(
        INIT_DIM=widths["init_dim"], PLANES=widths["planes"], LAYERS=widths["layers"]))
    model = unet(4, 19, torch.Generator().manual_seed(0))
    built = dataclasses.replace(built, model=model.to(device).eval())
    cfg = {"model": dict(widths, in_channels=4, num_classes=19)}
    ref = ref_minkunet.MinkUNet34C(cfg)
    state = weights.seeded_state({k: v.shape for k, v in ref.state_dict().items()},
                                 ref_models.param_kinds(ref), 3, device)
    built.model.load_state_dict(state)
    ref.load_state_dict(state)
    spec = ref_sparse.PyramidSpec(tuple(caps), 5, 3, ref_sparse.PackSpec(PACK.bits,
                                                                         PACK.offsets))
    return built, ref.to(device).eval(), ref_sparse.CartesianQuantizer(0.05), spec


def _against_reference(caps, widths, n, device="cpu"):
    built, ref, quantizer, spec = _built(caps, widths, device)
    clouds, mask, feats = _scans(2, n, device=device)
    out = inference.forward(built, clouds, mask, feats=feats)
    with torch.no_grad():
        want = ref_minkunet.forward(ref, quantizer, spec, clouds, mask, feats)
    assert out["logits"].shape == (2, n, 19) and out["logits"].dtype == torch.float32
    assert torch.equal(out["point_mask"], want["point_mask"])
    gap = compare.output_gaps(out, want, ["logits"])["logits_gap"]
    assert gap <= REL_TOL, gap
    assert not out["point_mask"][:, :12].any()
    assert not out["logits"][~out["point_mask"]].any()
    return out


def test_config_file_parses_to_the_published_model():
    params = ModelParams(CONFIG)
    assert (params.model, params.in_channels, params.num_classes) == ("MinkUNet34C", 4, 19)
    assert params.pack == PACK and params.quantizer.quant_step == 0.05
    assert params.capacities == [109696, 84736, 40960, 20608, 9984]
    built = model_factory(params, device="cpu")
    spec = built.pyramid_spec
    assert built.model_type == "minkunet" and spec.pack == PACK and spec.l0_block_map
    assert (built.model.PLANES, built.model.LAYERS) == (PUBLISHED["planes"],
                                                       PUBLISHED["layers"])
    n_params = sum(p.numel() for p in built.model.parameters())
    assert 37_000_000 < n_params < 39_000_000


def test_forward_at_reduced_widths_matches_the_reference():
    """2 clouds x 2,048 points; level 0 holds 1,536 voxels of ~1,900, so
    points in dropped voxels get zeros and False as well."""
    out = _against_reference((1536, 1536, 1024, 512, 256), REDUCED, 2048)
    assert 0.5 < out["point_mask"].float().mean() < 0.95


def test_forward_at_published_widths_matches_the_reference():
    """The published widths (F_in 384 into block5 through `width_plan` on
    the card), 2 clouds x 512 points."""
    _against_reference((512, 512, 512, 256, 256), PUBLISHED, 512)


def _pyramid(clouds, mask, caps):
    built = model_factory(ModelParams(CONFIG), device="cpu")
    spec = dataclasses.replace(built.pyramid_spec, capacities=tuple(caps))
    res = built.quantizer.quantize(clouds, mask, caps[0], need_index=False, pack=PACK,
                                   need_inverse=True)
    return res, tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec


def test_block_map_equals_a_direct_search():
    """Level 0's 3^3 map, the centre cube of the 5^3 map, equals the z-run
    search at k = 3 and the reference's sorted search, bit for bit, with
    voxels at the pack's z and x bounds."""
    clouds, mask, _ = _scans(2, 2048, seed=4)
    clouds[:, 12:40, 2] = torch.linspace(-6.4, 6.39, 28)   # z from the first to the last slot
    clouds[:, 40:60, 0] = torch.linspace(-51.2, 51.19, 20)
    res, pyr, spec = _pyramid(clouds, mask, [4096] * 5)
    l0 = pyr[0]
    direct = tpyr._self_kmap(res.keys, l0.coords, l0.mask, 3, PACK, presence_only=False)
    assert l0.kmap_block.shape == (2, 27, 4096) and l0.kmap_block.is_contiguous()
    assert torch.equal(l0.kmap_block, direct)
    queries = ref_sparse.neighbour_queries(l0.coords, l0.mask, 3, 1,
                                           ref_sparse.PackSpec(PACK.bits, PACK.offsets))
    assert torch.equal(l0.kmap_block, ref_sparse.lookup(res.keys, queries))
    assert torch.equal(l0.kmap_self[:, 62], l0.kmap_block[:, 13])  # the centre
    with pytest.raises(ValueError):
        dataclasses.replace(spec, conv0_ones=True)


def test_keys_and_inverse_equal_the_reference():
    """The new pack's keys, and each point's voxel row (the sentinel for a
    masked point, one outside the pack's range and one in a voxel beyond
    level 0's capacity), bit-equal to the reference's sorted search."""
    clouds, mask, _ = _scans(2, 2048, seed=6)
    quantizer = ModelParams(CONFIG).quantizer
    res = quantizer.quantize(clouds, mask, 1024, need_index=False, pack=PACK,
                             need_inverse=True)
    rpack = ref_sparse.PackSpec(PACK.bits, PACK.offsets)
    point_keys = ref_sparse.pack_keys(ref_sparse.CartesianQuantizer(0.05).voxels(clouds), mask,
                                      rpack)
    keys, rows, n_unique, _ = ref_sparse.dedup(point_keys, 1024)
    assert torch.equal(res.keys, keys) and torch.equal(res.n_unique, n_unique.to(torch.int32))
    assert torch.equal(res.index.long()[res.mask], rows[res.mask])
    inverse = ref_sparse.lookup(keys, point_keys)
    assert res.inverse.dtype == torch.int32 and torch.equal(res.inverse, inverse)
    dropped = (point_keys != MAXKEY) & (res.inverse == 1024)
    assert (n_unique > 1024).all() and dropped.any()
    assert (res.inverse[:, :12] == 1024).all()
    # the default pack gives other keys
    assert not torch.equal(quantizer.quantize(clouds, mask, 1024, need_index=False).keys,
                           res.keys)


EXISTING = {"egonn": "model_configs/egonn.txt",
            "minkloc3d_mulran": "model_configs/minkloc3d_mulran.txt",
            "minkloc3dv2_oxford": "model_configs/minkloc3dv2.txt"}


@pytest.mark.parametrize("name", sorted(EXISTING))
def test_existing_configurations_are_unchanged(name):
    """With the default pack and no second level-0 map: the keys equal the
    reference's default pack's, the pyramid has no 3^3 map, and the
    forward equals the parent commit's sequence of calls (quantize without
    a pack, build_pyramid, the model) bit for bit; features are refused."""
    params = ModelParams(EXISTING[name])
    built = model_factory(params, cap0=1024, device="cpu")
    spec = built.pyramid_spec
    assert spec.pack == DEFAULT_PACK and not spec.l0_block_map
    clouds, mask, _ = _scans(2, 1024, seed=8)
    clouds = clouds * (0.1 if name == "minkloc3dv2_oxford" else 10.0)
    res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    assert not hasattr(res, "inverse")
    ref_quantizer = (ref_sparse.PolarQuantizer(params.quantization_step) if name == "egonn"
                     else ref_sparse.CartesianQuantizer(params.quantization_step))
    keys, _, _ = ref_sparse.quantize(ref_quantizer, clouds, mask, spec.capacities[0])
    assert torch.equal(res.keys, keys)
    pyr = tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
    assert pyr[0].kmap_block is None
    with torch.no_grad():
        if name == "egonn":
            want = built.model(pyr, built.quantizer, disable_local_head=False)
        else:
            want = built.model(pyr, built.quantizer)
    got = inference.forward(built, clouds, mask)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError):
        inference.forward(built, clouds, mask, feats=torch.zeros(2, 1024, 4))


def test_minkunet_needs_features():
    built, _, _, _ = _built((512, 512, 512, 256, 256), REDUCED)
    clouds, mask, _ = _scans(2, 512)
    with pytest.raises(ValueError):
        inference.forward(built, clouds, mask)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_zrun_and_lookup_take_the_new_pack(cuda):
    """The z-run search (k = 5 and 3, 8 z bits) and the lookup's down mode
    (11-bit x and y) on the card, on the cell's scans at full size, bit-equal
    to their plain versions."""
    gen = scans.generator(cuda, 0, 2)
    clouds = scans.lidar_scans(2, 131072, gen)
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=cuda)
    params = ModelParams(CONFIG)
    spec = model_factory(params, device="cpu").pyramid_spec
    res = params.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False,
                                    pack=PACK)
    for k in (5, 3):
        q_lo, _, _ = tpyr._zrun_queries(res.coords_t, res.mask, k, PACK)
        got = kernels.zrun_rank(res.keys, q_lo, kz=k)
        want = kernels.zrun_plain(res.keys, q_lo, kz=k)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(kernels.zrun_presence(res.keys, q_lo, kz=k), want[0])
    spec = dataclasses.replace(spec, up_levels=())
    _, _, keys, _, _ = tpyr._dedup_chain(res.keys, spec)
    keys = [res.keys] + keys
    packs = [spec.pack_at(l) for l in range(5)]
    got = kernels.lookup_down(keys, packs, [1, 2, 3, 4])
    want = kernels.lookup_down_plain(keys, packs, [1, 2, 3, 4])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_card_forward_at_published_widths_matches_the_reference(cuda):
    _against_reference((4096, 4096, 2048, 1024, 512), PUBLISHED, 8192, device=cuda)
