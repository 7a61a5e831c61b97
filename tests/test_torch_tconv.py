"""The transposed k=2 s=2 conv (`kernels.tconv`, `csrc/tconv.cu`) and the
slot order it runs over (`kernels.slot_order`, kept per level by
`sparse/conv.py::level_slots`).

CPU cases check that the slot order is stable, holds every row with a
parent once in its slot's segment and leaves sentinel-parent and padding
rows to the last segment, on a real pyramid and on synthetic up maps; that
the per-slot form over it (the kernel's arithmetic in torch) equals the
plain version, the all-slot product, within f32 rounding at widths 32-256;
that a CPU level builds no order; and that CPU calls launch nothing.
Cases marked `cuda` hold the counting sort on the card against the plain
version's torch sort, bit for bit, and the kernel against the all-slot f32
product at rel 1e-5 at the cells' transposed-conv and down-conv-dX shapes
(sentinel parents, padding rows, an empty cloud, B = 1 to 128) and at odd
widths, check that repeats are bit-equal, that a card level builds its
order once, that the kernel path refuses a gradient, and that
`_Tconv2x2`'s and `_ConvDown`'s outputs and gradients on the card match
the CPU's; they skip without a card.  This module imports no
JAX, so on a machine with only torch they run with

    python -m pytest tests/test_torch_tconv.py -m cuda --noconftest -p no:cacheprovider
"""
import dataclasses

import numpy as np
import pytest
import torch

from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.ops.quantization import PolarQuantizer
from egonn_tpu_torch.sparse import conv as sconv
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse import pyramid as tpyr

# split TF32 against the f32 product, of max |product| (chip_smoke's
# FLOAT_REL_TOL); the transposed conv's dW sums every fine row (DW_REL_TOL)
REL_TOL, DW_REL_TOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pyr():
    clouds = torch.from_numpy(lidar_scan_clouds(2, 4096, seed=5))
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    spec = tpyr.egonn_pyramid_spec(cap0=1024, num_levels=3)
    res = PolarQuantizer([1.0, 0.3, 0.2]).quantize(clouds, mask, spec.capacities[0],
                                                   need_index=False)
    return tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys, with_kmap_down=True)


def _up_map(seed, b, c_coarse, c_fine, density=0.8, sentinels=0.05):
    """A synthetic up map (B, C_fine): per cloud a random count of rows with
    a parent (parents ascending with repeats, as a key-sorted level's are
    nearly), some of them the sentinel c_coarse, and padding rows after them
    (sentinel parent, slot 0); cloud 0 empty when b > 1."""
    gen = np.random.default_rng(seed)
    parent = np.full((b, c_fine), c_coarse, np.int32)
    slot = np.zeros((b, c_fine), np.int32)
    for i in range(b):
        n = 0 if (b > 1 and i == 0) else int(c_fine * gen.uniform(density / 2, density))
        parent[i, :n] = np.sort(gen.integers(0, c_coarse, n))
        parent[i, :n][gen.random(n) < sentinels] = c_coarse
        slot[i, :n] = gen.integers(0, 8, n)
    return torch.from_numpy(parent), torch.from_numpy(slot)


def _inputs(seed, b, c_coarse, c_fine, f_in, f_out):
    up_parent, up_koffset = _up_map(seed, b, c_coarse, c_fine)
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn((b, c_coarse, f_in), generator=gen)
    kernel = torch.randn((8, f_in, f_out), generator=gen) / np.sqrt(f_in)
    return feats, up_parent, up_koffset, kernel


def _check_order(up_parent, up_koffset, c_coarse, slots):
    order, seg = slots.order.cpu().numpy(), slots.seg.cpu().numpy()
    parent, slot = up_parent.cpu().numpy(), up_koffset.cpu().numpy()
    b, c_fine = parent.shape
    assert order.dtype == np.int32 and seg.dtype == np.int32 and seg.shape == (b, 10)
    for i in range(b):
        valid = (parent[i] >= 0) & (parent[i] < c_coarse)
        assert seg[i, 0] == 0 and seg[i, 9] == c_fine and np.all(np.diff(seg[i]) >= 0)
        for s in range(9):
            want = np.flatnonzero(~valid if s == 8 else valid & (slot[i] == s))
            np.testing.assert_array_equal(order[i, seg[i, s]:seg[i, s + 1]], want)


def test_slot_order_is_stable_and_covers_the_valid_rows(pyr):
    """Each slot's rows in ascending order, every row with a parent once,
    sentinel-parent and padding rows in the last segment alone."""
    # rows whose parent the coarse level's capacity dropped, and padding rows
    assert bool((pyr[0].mask & (pyr[0].up_parent == pyr[1].capacity)).any())
    assert bool((~pyr[2].mask & (pyr[2].up_parent == pyr[3].capacity)).any())
    for l in range(3):
        fine = pyr[l]
        c_coarse = pyr[l + 1].capacity
        _check_order(fine.up_parent, fine.up_koffset, c_coarse,
                     kernels.slot_order(fine.up_parent, fine.up_koffset, c_coarse))
    up_parent, up_koffset = _up_map(0, 4, 300, 700)
    _check_order(up_parent, up_koffset, 300, kernels.slot_order(up_parent, up_koffset, 300))


def test_level_slots_off_the_card_are_none(pyr):
    """The CPU multiplies all slots (`tconv_plain`), so a CPU level builds no
    slot order; neither does the top level (no up map)."""
    for l in range(3):
        assert sconv.level_slots(pyr[l], pyr[l + 1].capacity, torch.float32) is None
        assert pyr[l].up_slots is None
    assert sconv.level_slots(pyr[3], 1, torch.float32) is None


def _per_slot(feats, up_parent, kernel, slots):
    """The kernel's arithmetic in plain torch: each cloud's segment s of the
    slot order gathers its rows' parents and multiplies them by kernel[s]
    alone, the last segment's rows are zero."""
    b, c_fine = up_parent.shape
    out = feats.new_zeros((b, c_fine, kernel.shape[2]))
    for i in range(b):
        for s in range(8):
            rows = slots.order[i, slots.seg[i, s]:slots.seg[i, s + 1]].long()
            out[i, rows] = feats[i, up_parent[i, rows].long()] @ kernel[s]
    return out


@pytest.mark.parametrize("f", [32, 64, 128, 256])
def test_plain_per_slot_form_equals_the_all_slot_product(pyr, f):
    """Each segment's rows times its slot's kernel alone, over the slot
    order, and the all-slot product's kept slot (`tconv_plain`) differ in
    f32 rounding alone; rows without a parent are zero in both."""
    gen = torch.Generator().manual_seed(f)
    for l in range(3):
        fine, coarse = pyr[l], pyr[l + 1]
        feats = torch.randn((2, coarse.capacity, f), generator=gen)
        kernel = torch.randn((8, f, f), generator=gen) / np.sqrt(f)
        slots = kernels.slot_order(fine.up_parent, fine.up_koffset, coarse.capacity)
        got = _per_slot(feats, fine.up_parent, kernel, slots)
        want = kernels.tconv_plain(feats, fine.up_parent, fine.up_koffset, kernel)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= REL_TOL * scale
        none = fine.up_parent >= coarse.capacity
        assert bool((got[none] == 0).all()) and bool((want[none] == 0).all())


def test_plain_forms_on_synthetic_maps_and_bf16():
    feats, up_parent, up_koffset, kernel = _inputs(1, 3, 200, 500, 36, 40)
    got = _per_slot(feats, up_parent, kernel, kernels.slot_order(up_parent, up_koffset, 200))
    want = kernels.tconv_plain(feats, up_parent, up_koffset, kernel)
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())
    # the CPU runs the plain version; bf16 activations keep it on any device
    np.testing.assert_array_equal(sconv.sparse_tconv2x2(feats, up_parent, up_koffset,
                                                        kernel).numpy(), want.numpy())
    f16 = feats.to(torch.bfloat16)
    got16 = sconv.sparse_tconv2x2(f16, up_parent, up_koffset, kernel)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got16.float().numpy(),
        kernels.tconv_plain(f16, up_parent, up_koffset, kernel).float().numpy())


def test_cpu_calls_launch_nothing(pyr):
    kernels.reset_launches()
    fine, coarse = pyr[0], pyr[1]
    feats = torch.ones((2, coarse.capacity, 8))
    kernel = torch.ones((8, 8, 32))
    out = sconv.sparse_tconv2x2(feats, fine.up_parent, fine.up_koffset, kernel,
                                sconv.level_slots(fine, coarse.capacity, feats.dtype))
    assert out.shape == (2, fine.capacity, 32)
    assert kernels.launch_counts()["tconv"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (B, C_coarse, C_fine, F_in, F_out): the cells' transposed convs and
# down-conv dX calls (capacities of their pyramids), then small and odd ones
CELL_SHAPES = [
    (64, 5120, 10240, 256, 256),   # minkloc3d.embed-b64: MinkFPN's top-down step, L3 -> L2
    (128, 1024, 1408, 128, 128),   # egonn.embed-b128: the global head, L7 -> L6
    (128, 1408, 1664, 128, 128),   # ... L6 -> L5
    (128, 2560, 4096, 64, 64),     # ... the local head, L4 -> L3
    (128, 384, 896, 256, 256),     # minkloc3dv2.train-b2048: a chunk's top-down steps
    (128, 896, 2048, 256, 256),
    (128, 3328, 4096, 64, 64),     # ... its down convs' dX, L1 -> L0
    (128, 2048, 3328, 64, 64),
    (128, 896, 2048, 128, 128),
    (128, 384, 896, 64, 64),
    (48, 9856, 16384, 32, 32),     # egonn.train-b48: the down convs' dX, L1 -> L0
    (48, 6656, 9856, 32, 32),
    (48, 4096, 6656, 64, 64),
    (48, 1664, 2560, 128, 128),
]
SMALL_SHAPES = [
    (1, 100, 300, 64, 64),
    (1, 1, 5, 32, 32),
    (8, 700, 1500, 128, 128),
    (8, 300, 600, 4, 32),          # the stem's width into a 32-wide level
    (8, 300, 600, 36, 96),         # F_in not a stage's multiple, F_out not 64's
    (8, 300, 600, 64, 48),         # F_out padded by the width plan
    (2, 300, 600, 600, 40),        # F_in split by the width plan
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES + SMALL_SHAPES)
def test_kernel_matches_the_all_slot_product(cuda, shape):
    feats, up_parent, up_koffset, kernel = (t.to(cuda) for t in _inputs(7, *shape))
    kernels.reset_launches()
    got = kernels.tconv(feats, up_parent, up_koffset, kernel)
    plan = kernels.width_plan(shape[3], shape[4])
    assert kernels.launch_counts()["tconv"] == len(plan.in_chunks) * len(plan.out_chunks)
    want = kernels.tconv_plain(feats, up_parent, up_koffset, kernel)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= REL_TOL * max(scale, 1e-30), (err, scale)
    none = (up_parent >= shape[1])
    assert bool((got[none] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [CELL_SHAPES[0], CELL_SHAPES[10], SMALL_SHAPES[3]])
def test_kernel_repeats_bit_equal(cuda, shape):
    feats, up_parent, up_koffset, kernel = (t.to(cuda) for t in _inputs(11, *shape))
    slots = kernels.slot_order(up_parent, up_koffset, shape[1])
    _check_order(up_parent, up_koffset, shape[1], slots)
    first = kernels.tconv(feats, up_parent, up_koffset, kernel, slots)
    for _ in range(2):
        assert torch.equal(kernels.tconv(feats, up_parent, up_koffset, kernel), first)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES[:4] + CELL_SHAPES[10:11] + SMALL_SHAPES[:2])
def test_slot_order_kernel_equals_the_sort(cuda, shape):
    """The counting sort on the card against the plain version's stable torch
    sort, bit for bit, in one launch."""
    up_parent, up_koffset = (t.to(cuda) for t in _up_map(5, shape[0], shape[1], shape[2]))
    kernels.reset_launches()
    got = kernels.slot_order(up_parent, up_koffset, shape[1])
    assert kernels.launch_counts()["slot_order"] == 1
    want = kernels.slot_order_plain(up_parent, up_koffset, shape[1])
    assert torch.equal(got.order, want.order) and torch.equal(got.seg, want.seg)


@pytest.mark.cuda
def test_level_slots_are_built_once(cuda, pyr):
    """A card level builds its slot order at the first call and keeps it;
    bf16 activations (the all-slot product) take none."""
    fine = dataclasses.replace(pyr[1], up_parent=pyr[1].up_parent.to(cuda),
                               up_koffset=pyr[1].up_koffset.to(cuda), up_slots=None)
    c_coarse = pyr[2].capacity
    assert sconv.level_slots(fine, c_coarse, torch.bfloat16) is None
    kernels.reset_launches()
    slots = sconv.level_slots(fine, c_coarse, torch.float32)
    assert fine.up_slots is slots and sconv.level_slots(fine, c_coarse, torch.float32) is slots
    assert kernels.launch_counts()["slot_order"] == 1
    _check_order(fine.up_parent, fine.up_koffset, c_coarse, slots)


@pytest.mark.cuda
def test_kernel_path_refuses_a_gradient(cuda):
    feats, up_parent, up_koffset, kernel = (t.to(cuda) for t in _inputs(3, 2, 50, 90, 32, 32))
    with pytest.raises(NotImplementedError, match="sparse_tconv2x2_vjp"):
        sconv.sparse_tconv2x2(feats.requires_grad_(), up_parent, up_koffset, kernel)
    with pytest.raises(TypeError, match="f32"):
        kernels._tconv_cuda(feats.detach().to(torch.bfloat16), up_parent, kernel,
                            kernels.slot_order(up_parent, up_koffset, 50))


def _vjp(fn, args, g):
    """(out, d feats, d kernel) of fn(feats, ..., kernel) against g."""
    feats = args[0].clone().requires_grad_(True)
    kernel = args[-1].clone().requires_grad_(True)
    out = fn(feats, *args[1:-1], kernel)
    d_feats, d_kernel = torch.autograd.grad(out, (feats, kernel), g)
    return out.detach().cpu(), d_feats.cpu(), d_kernel.cpu()


def _close(got, want, tol, what):
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-30), (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_custom_gradients_on_the_card_match_the_cpu(cuda, pyr, level):
    """`_Tconv2x2` (forward: the kernel over the level's slot order) and
    `_ConvDown` (dX: the kernel) on the card against the same Functions on
    the CPU (their plain versions)."""
    fine, coarse = pyr[level], pyr[level + 1]
    gen = torch.Generator().manual_seed(level)
    f = (32, 64, 128)[level]
    up = (fine.up_parent, fine.up_koffset)
    tconv_args = (torch.randn((2, coarse.capacity, f), generator=gen), *up, coarse.kmap_down,
                  torch.randn((8, f, f), generator=gen) / np.sqrt(8 * f))
    g_fine = torch.randn((2, fine.capacity, f), generator=gen)
    down_args = (torch.randn((2, fine.capacity, f), generator=gen), coarse.kmap_down, *up,
                 torch.randn((8, f, f), generator=gen) / np.sqrt(8 * f))
    g_coarse = torch.randn((2, coarse.capacity, f), generator=gen) * coarse.mask[..., None]
    for fn, args, g in ((sconv.sparse_tconv2x2_vjp, tconv_args, g_fine),
                        (sconv.sparse_conv_down, down_args, g_coarse)):
        want = _vjp(fn, args, g)
        kernels.reset_launches()
        got = _vjp(fn, tuple(a.to(cuda) for a in args), g.to(cuda))
        assert kernels.launch_counts()["tconv"] == 1
        for x, y, what, tol in zip(got, want, ("out", "dX", "dW"),
                                   (REL_TOL, REL_TOL, DW_REL_TOL)):
            _close(x, y, tol, f"{fn.__name__} {what}")
