"""The port's kernel wrappers (egonn_tpu_torch.sparse.kernels) on random data.

CPU cases check the plain versions against brute force and the dispatch
rules: the width rules of the conv kernels, the width plan that pads and
splits any other width (run with the plain versions as the launches), and
the split-TF32 arithmetic of gather_conv / tdown / gather_dw emulated in
numpy.  Cases marked `cuda` hold each CUDA kernel against its plain version
(the bf16 gather_conv and tdown within one bf16 ulp of theirs, the bf16
gather_dw within 1e-4 of max |plain|)
on odd shapes and edge cases (ragged tiles, all-sentinel maps, a deep
level's single occupied tile, widths to 512, F_in != F_out at K = 8 and 27,
widths the kernels take only through the plan: 1, 3, 48, 1024; the grouped
lookup over empty clouds, single voxels, dropped children and a forced
overflow), check that repeats are bit-equal and that bad inputs raise; they
skip without a card.  This module
imports no JAX, so on a machine with only torch they run with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider
"""
import itertools

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu_torch.sparse import cuda_lib, kernels
from egonn_tpu_torch.sparse.packing import MAXKEY

# split-TF32 tensor-core kernels against f32 torch matmuls: f32 accuracy,
# another summation order (test_split_tf32_meets_the_f32_tolerance)
REL_TOL = 1e-5
# gather_dw sums up to B x C_out rows per weight in another order (per-chunk
# partials, then the chunks) than the plain einsum: max abs error <= 1e-4 x
# max |plain|
DW_REL_TOL = 1e-4
# bf16 kernels against their bf16 plain versions: both round the same f32
# sums once, summed in another order, so an output may land one bf16 ulp
# away; outputs near 0 (cancellations, ReLU's edge) within 1e-6 x max |plain|
BF16_ABS_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted_keys(gen, b, c_in, n_valid, spread):
    keys = np.full((b, c_in), MAXKEY, np.int32)
    for i in range(b):
        keys[i, :n_valid] = np.sort(gen.choice(spread, n_valid, replace=False))
    return keys


def _queries(gen, keys, shape, spread):
    q = gen.integers(0, spread, size=shape).astype(np.int32)
    # half the queries start at a present key, some are invalid
    b = keys.shape[0]
    pick = keys[np.arange(b)[:, None, None], gen.integers(0, keys.shape[1] // 2, size=shape)]
    q = np.where(gen.random(shape) < 0.5, pick, q)
    return np.where(gen.random(shape) < 0.1, MAXKEY, q).astype(np.int32)


def _brute_zrun(keys, q, kz):
    bits = np.zeros(q.shape, np.int64)
    rank = np.zeros(q.shape, np.int64)
    for idx in np.ndindex(q.shape):
        if q[idx] == MAXKEY:
            continue
        row = keys[idx[0]].astype(np.int64)
        rank[idx] = int((row < q[idx]).sum())
        present = set(row.tolist())
        bits[idx] = sum(1 << j for j in range(kz) if int(q[idx]) + j in present)
    return bits, rank


@pytest.mark.parametrize("kz", [3, 5])
def test_zrun_plain_matches_brute_force(kz):
    gen = np.random.default_rng(kz)
    keys = _sorted_keys(gen, 2, 64, 40, 200)
    q = _queries(gen, keys, (2, 3, 50), 200)
    bits, rank = kernels.zrun_rank(torch.from_numpy(keys), torch.from_numpy(q), kz)
    want_bits, want_rank = _brute_zrun(keys, q, kz)
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(
        kernels.zrun_presence(torch.from_numpy(keys), torch.from_numpy(q), kz).numpy(),
        want_bits)


def test_invert_up_matches_brute_force():
    gen = np.random.default_rng(0)
    b, c_fine, c_coarse = 2, 300, 70
    parent = np.full((b, c_fine), c_coarse, np.int32)
    slot = gen.integers(0, 8, size=(b, c_fine)).astype(np.int32)
    for i in range(b):
        cells = gen.choice(8 * c_coarse, 200, replace=False)
        rows = gen.choice(c_fine, 200, replace=False)
        parent[i, rows], slot[i, rows] = cells % c_coarse, cells // c_coarse
    child = kernels.invert_up(torch.from_numpy(parent), torch.from_numpy(slot), c_coarse)
    want = np.full((b, 8, c_coarse), c_fine, np.int32)
    for i, f in zip(*np.nonzero(parent < c_coarse)):
        want[i, slot[i, f], parent[i, f]] = f
    np.testing.assert_array_equal(child.numpy(), want)


def test_gather_dw_plain_matches_brute_force():
    gen = np.random.default_rng(3)
    b, c_in, k_vol, c_out, f_in, f_out = 2, 40, 5, 30, 4, 3
    feats = gen.standard_normal((b, c_in, f_in)).astype(np.float32)
    kmap = gen.integers(0, c_in + 1, size=(b, k_vol, c_out)).astype(np.int32)
    kmap[0, 1, 3] = -1        # out of range on both sides: zero rows
    kmap[1, 2, 4] = c_in + 7
    g = gen.standard_normal((b, c_out, f_out)).astype(np.float32)
    want = np.zeros((k_vol, f_in, f_out))
    for i, k, o in np.ndindex(b, k_vol, c_out):
        if 0 <= kmap[i, k, o] < c_in:
            want[k] += np.outer(feats[i, kmap[i, k, o]], g[i, o])
    got = kernels.gather_dw(torch.from_numpy(feats), torch.from_numpy(kmap), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_calls_count_no_launches():
    kernels.reset_launches()
    feats = torch.randn(1, 10, 4)
    kmap = torch.randint(0, 11, (1, 27, 10), dtype=torch.int32)
    kernels.gather_conv(feats, kmap, torch.randn(27, 4, 32))
    kernels.gather_dw(feats, kmap, torch.randn(1, 10, 32))
    keys = torch.arange(0, 40, 2, dtype=torch.int32)[None]
    assert kernels.lookup(keys, torch.tensor([[[4, 5, MAXKEY]]], dtype=torch.int32)).tolist() \
        == [[[2, 20, 20]]]
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_other_devices_raise():
    meta = torch.empty(1, 10, 4, device="meta")
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        kernels.gather_conv(meta, torch.zeros(1, 27, 10, dtype=torch.int32),
                            torch.zeros(27, 4, 32))


def test_conv_width_rule():
    """gather_conv / tdown take F_out a multiple of 32 up to 512, F_in a
    multiple of 4 up to 128 or of 32 up to 512; everything else raises."""
    f_outs = {f for f in range(600) if f % 32 == 0 and 32 <= f <= 512}
    f_ins = {f for f in range(600) if (f % 4 == 0 and 4 <= f <= 128)
             or (f % 32 == 0 and 32 <= f <= 512)}
    for f in range(600):
        assert kernels.conv_widths_ok(4, f) == (f in f_outs)
        assert kernels.conv_widths_ok(f, 32) == (f in f_ins)
    for f_in, f_out in [(4, 48), (32, 520), (520, 32), (132, 64), (2, 32)]:
        with pytest.raises(ValueError, match="F_in"):
            kernels._check_widths(f_in, f_out, "gather_conv", 1000)
    with pytest.raises(ValueError, match="2\\^24"):
        kernels._check_widths(32, 32, "gather_conv", 1 << 24)


# call shapes of the EgoNN forward and train step, MinkLoc and ResNet widths
# (B, C_out, F_in, F_out, K)
_CONV_SHAPES = [(8, 6656, 64, 64, 27), (8, 4096, 32, 64, 8), (8, 1664, 128, 128, 27),
                (32, 1664, 128, 128, 27), (1, 64, 512, 256, 8), (4, 4096, 256, 288, 27),
                (8, 9856, 4, 32, 27)]


@pytest.mark.parametrize("b,c_out,f_in,f_out,k_vol", _CONV_SHAPES)
def test_conv_column_slice(b, c_out, f_in, f_out, k_vol):
    """The column slice is one the kernel takes (32 or 64, dividing F_out)."""
    cols = kernels.conv_cols(b, c_out, f_out, k_vol)
    assert cols in (32, 64) and f_out % cols == 0


@pytest.mark.parametrize("b,c_out,f_in,f_out,k_vol", _CONV_SHAPES)
def test_conv_offset_groups(b, c_out, f_in, f_out, k_vol):
    """1 to min(4, K) blocks share a tile's offsets, and more than one only
    on grids of at most _SPLIT_BLOCKS blocks."""
    groups = kernels.offset_groups(b, c_out, f_in, f_out, k_vol)
    assert 1 <= groups <= min(4, k_vol)
    if groups > 1:
        cols = kernels.conv_cols(b, c_out, f_out, k_vol)
        assert b * -(-c_out // 128) * (f_out // cols) <= kernels._SPLIT_BLOCKS


def test_dw_width_rule():
    """gather_dw takes F_in and F_out multiples of 32 up to 512."""
    ok = {f for f in range(600) if f % 32 == 0 and 32 <= f <= 512}
    for f in range(600):
        assert kernels.dw_widths_ok(f, 64) == (f in ok)
        assert kernels.dw_widths_ok(64, f) == (f in ok)
    for f_in, f_out in [(48, 32), (32, 48), (520, 32), (32, 520), (36, 64)]:
        assert not kernels.dw_widths_ok(f_in, f_out)


# (F_in, F_out) -> padded widths and chunks: gather_conv / tdown, gather_dw
_PLANS = {
    (1, 48): ((4, 64, ((0, 4),), ((0, 64),)), (32, 64, ((0, 32),), ((0, 64),))),
    (3, 32): ((4, 32, ((0, 4),), ((0, 32),)), (32, 32, ((0, 32),), ((0, 32),))),
    (48, 512): ((48, 512, ((0, 48),), ((0, 512),)), (64, 512, ((0, 64),), ((0, 512),))),
    (512, 1024): ((512, 1024, ((0, 512),), ((0, 512), (512, 1024))),
                  (512, 1024, ((0, 512),), ((0, 512), (512, 1024)))),
    (1024, 1024): ((1024, 1024, ((0, 512), (512, 1024)), ((0, 512), (512, 1024))),) * 2,
    (2048, 3): ((2048, 32, ((0, 512), (512, 1024), (1024, 1536), (1536, 2048)), ((0, 32),)),
                (2048, 32, ((0, 512), (512, 1024), (1024, 1536), (1536, 2048)), ((0, 32),))),
    (130, 600): ((160, 608, ((0, 160),), ((0, 512), (512, 608))),
                 (160, 608, ((0, 160),), ((0, 512), (512, 608)))),
}


@pytest.mark.parametrize("f_in,f_out", list(_PLANS))
def test_width_plan(f_in, f_out):
    """Padding and splits of `width_plan`; every launch is one the kernel
    takes, and the chunks tile the padded widths."""
    for dw, want in zip((False, True), _PLANS[(f_in, f_out)]):
        plan = kernels.width_plan(f_in, f_out, dw=dw)
        assert tuple(plan) == want, (dw, plan)
        ok = kernels.dw_widths_ok if dw else kernels.conv_widths_ok
        for (i0, i1), (o0, o1) in itertools.product(plan.in_chunks, plan.out_chunks):
            assert ok(i1 - i0, o1 - o0)
        assert plan.f_in >= f_in and plan.f_out >= f_out


def _plan_inputs(gen, b, c_in, c_out, k_vol, f_in, f_out):
    feats = torch.from_numpy(gen.standard_normal((b, c_in, f_in)).astype(np.float32))
    kmap = torch.from_numpy(np.where(gen.random((b, k_vol, c_out)) < 0.5, c_in,
                                     gen.integers(0, c_in, (b, k_vol, c_out))).astype(np.int32))
    kernel = torch.from_numpy(gen.standard_normal((k_vol, f_in, f_out)).astype(np.float32))
    return feats, kmap, kernel


def _launches(calls, kind):
    """A plain launch that records its widths and refuses any the kernel
    does not take."""
    def conv(f, w, e, kmap):
        assert kernels.conv_widths_ok(w.shape[1], w.shape[2]) and f.shape[2] == w.shape[1]
        calls.append((w.shape[1], w.shape[2]))
        return kernels.gather_conv_plain(f, kmap, w, e)

    def dw(f, g, kmap):
        assert kernels.dw_widths_ok(f.shape[2], g.shape[2])
        calls.append((f.shape[2], g.shape[2]))
        return kernels.gather_dw_plain(f, kmap, g)
    return conv if kind == "conv" else dw


@pytest.mark.parametrize("f_in,f_out", [(1, 48), (3, 32), (1024, 1024), (130, 600)])
@pytest.mark.parametrize("with_epi", [False, True])
def test_planned_conv_equals_plain(f_in, f_out, with_epi):
    """A gather conv run over the width plan (padded, split, the split F_in's
    sums added before the epilogue) equals the unpadded plain conv."""
    gen = np.random.default_rng(f_in + f_out)
    b, c_in, c_out, k_vol = 2, 40, 30, 8
    feats, kmap, kernel = _plan_inputs(gen, b, c_in, c_out, k_vol, f_in, f_out)
    epi = None
    if with_epi:
        epi = (torch.from_numpy(gen.uniform(0.5, 1.5, f_out).astype(np.float32)),
               torch.from_numpy(gen.normal(0, 0.3, f_out).astype(np.float32)), True,
               torch.from_numpy(gen.random((b, c_out)) < 0.8))
    calls = []
    launch = _launches(calls, "conv")
    plan = kernels.width_plan(f_in, f_out)
    got = kernels.planned_conv(lambda f, w, e: launch(f, w, e, kmap), feats, kernel, epi, plan)
    want = kernels.gather_conv_plain(feats, kmap, kernel, epi)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert len(calls) == len(plan.in_chunks) * len(plan.out_chunks)


@pytest.mark.parametrize("f_in,f_out", [(1, 48), (3, 1024), (1024, 32), (600, 600)])
def test_planned_dw_equals_plain(f_in, f_out):
    """gather_dw run over the width plan (padded, split into independent
    blocks of dW) equals the unpadded plain dW."""
    gen = np.random.default_rng(f_in * f_out)
    b, c_in, c_out, k_vol = 2, 40, 30, 8
    feats, kmap, _ = _plan_inputs(gen, b, c_in, c_out, k_vol, f_in, 1)
    g = torch.from_numpy(gen.standard_normal((b, c_out, f_out)).astype(np.float32))
    calls = []
    launch = _launches(calls, "dw")
    plan = kernels.width_plan(f_in, f_out, dw=True)
    got = kernels.planned_dw(lambda f, gg: launch(f, gg, kmap), feats, g, k_vol, plan)
    want = kernels.gather_dw_plain(feats, kmap, g)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert len(calls) == len(plan.in_chunks) * len(plan.out_chunks)


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round the f32 mantissa to 10 bits, ties away from
    zero (the sign bit is untouched, so adding half an ulp to the bits
    rounds the magnitude)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_rna_rounding():
    # ties (2^-11 past 1) go away from zero, either sign
    x = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-12,
                  1.0 + 2.0**-12, 0.0], np.float32)
    want = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0 + 2.0**-10,
                     1.0, 0.0], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), want)
    # hi + lo recovers x to 2^-22 of |x|
    gen = np.random.default_rng(1)
    v = gen.standard_normal(10_000).astype(np.float32) * np.float32(1e3)
    hi = _tf32_rna(v)
    lo = _tf32_rna(v - hi)
    assert np.all(np.abs(v.astype(np.float64) - hi - lo) <= 2.0**-22 * np.abs(v))


def _trunc_f32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero, as the tensor cores' f32 accumulation
    rounds."""
    f = x.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(x), np.nextafter(f, np.float32(0)), f)


def _gather_conv_tf32(stage: int, chain: str):
    """A K = 27, 128 x 128 gather conv in the kernels' arithmetic: operands
    split by cvt.rna into TF32 hi + lo, each mma.sync m16n8k8 step an exact
    8-deep dot product added to its accumulator and rounded toward zero to
    f32.  The three products lo*hi, hi*lo, hi*hi of each `stage`-deep stage
    go, with chain "sets", to three fresh accumulators, whose sum
    c0 + (c1 + c2) is added to the running sum in f32 (round to nearest:
    gather_mm.cuh); with "stage", one after the other to one fresh
    accumulator, added likewise (gather_dw.cu); with "all", through one
    accumulator for the whole conv (1,296 steps).  Returns (split, single
    TF32 hi*hi with f32 sums, f64 result)."""
    gen = np.random.default_rng(27)
    k_vol, c_in, c_out, f = 27, 600, 256, 128
    feats = gen.standard_normal((c_in, f)).astype(np.float32)
    kmap = np.where(gen.random((k_vol, c_out)) < 0.6, gen.integers(0, c_in, (k_vol, c_out)), -1)
    w = (gen.standard_normal((k_vol, f, f)) / np.sqrt(f)).astype(np.float32)
    rows = np.where(kmap[..., None] >= 0, feats[kmap], 0).astype(np.float32)  # (K, C_out, F)
    exact = np.einsum("kcf,kfo->co", rows.astype(np.float64), w.astype(np.float64))
    r_hi, w_hi = _tf32_rna(rows), _tf32_rna(w)
    r_lo, w_lo = _tf32_rna(rows - r_hi), _tf32_rna(w - w_hi)
    r_hi, r_lo, w_hi, w_lo = (x.astype(np.float64) for x in (r_hi, r_lo, w_hi, w_lo))
    split = np.zeros((c_out, f), np.float32)
    single = np.zeros((c_out, f), np.float32)
    for k in range(k_vol):
        single += (r_hi[k] @ w_hi[k]).astype(np.float32)
        for c0 in range(0, f, stage):
            sets = [np.zeros((c_out, f), np.float32) for _ in range(3)]
            for kk in range(c0, c0 + stage, 8):
                d = slice(kk, kk + 8)
                for j, (a, b) in enumerate(((r_lo, w_hi), (r_hi, w_lo), (r_hi, w_hi))):
                    if chain == "all":
                        split = _trunc_f32(split + a[k][:, d] @ b[k][d])
                    else:
                        j = j if chain == "sets" else 0
                        sets[j] = _trunc_f32(sets[j] + a[k][:, d] @ b[k][d])
            if chain != "all":
                split += sets[2] + (sets[0] + sets[1])
    return split, single, exact


# gather_conv: 32-column F_in chunks, three accumulators; gather_dw: 64-row
# tiles, one accumulator
@pytest.mark.parametrize("stage,chain", [(32, "sets"), (64, "stage")])
def test_split_tf32_meets_the_f32_tolerance(stage, chain):
    """Split TF32 with fresh accumulators each stage stays within 1e-5 x
    max |exact| of the f64 result (chip_smoke's FLOAT_REL_TOL), and one TF32
    product does not."""
    split, single, exact = _gather_conv_tf32(stage, chain)
    scale = np.abs(exact).max()
    assert np.abs(split - exact).max() <= 1e-5 * scale
    assert np.abs(single - exact).max() > 1e-4 * scale


def test_chained_tf32_accumulator_misses_the_f32_tolerance():
    """All of a conv's split products through one truncating accumulator
    miss 1e-5 x max |exact|: why the kernels start each stage afresh."""
    split, _, exact = _gather_conv_tf32(32, "all")
    assert np.abs(split - exact).max() > 1e-5 * np.abs(exact).max()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _epi(gen, f_out, b, c_out, device, relu=True):
    return (torch.from_numpy(gen.uniform(0.5, 1.5, f_out).astype(np.float32)).to(device),
            torch.from_numpy(gen.normal(0, 0.3, f_out).astype(np.float32)).to(device),
            relu, torch.from_numpy(gen.random((b, c_out)) < 0.8).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", [(4, 32), (36, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("with_epi", [False, True])
def test_gather_conv_cuda_matches_plain(cuda, f_in, f_out, with_epi):
    gen = np.random.default_rng(f_in + f_out)
    b, c_in, k, c_out = 3, 1000, 27, 777  # a ragged last tile
    feats = torch.from_numpy(gen.standard_normal((b, c_in, f_in)).astype(np.float32)).to(cuda)
    kmap = gen.integers(0, c_in, size=(b, k, c_out))
    kmap = np.where(gen.random((b, k, c_out)) < 0.6, c_in, kmap).astype(np.int32)
    kmap[:, :, 500:] = c_in  # whole tiles of sentinels
    kmap = torch.from_numpy(kmap).to(cuda)
    kernel = torch.from_numpy(gen.standard_normal((k, f_in, f_out)).astype(np.float32)).to(cuda)
    epi = _epi(gen, f_out, b, c_out, cuda) if with_epi else None
    before = kernels.launch_counts()["gather_conv"]
    got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_conv"] == before + 1
    want = kernels.gather_conv_plain(feats, kmap, kernel, epi=epi)
    assert _rel_err(got, want) <= REL_TOL
    if not with_epi:
        assert float(got[:, 512:].abs().max()) == 0.0
    assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)


def _sparse_kmap(gen, b, k_vol, c_in, c_out, n_valid, p_valid=0.4):
    """Self-map-like: rows below n_valid gather from [0, n_valid) with
    probability p_valid (the centre offset always itself), the rest sentinel."""
    kmap = np.where(gen.random((b, k_vol, c_out)) < p_valid,
                    gen.integers(0, n_valid, size=(b, k_vol, c_out)), c_in)
    kmap[:, k_vol // 2, :] = np.arange(c_out)
    kmap[:, :, n_valid:] = c_in
    return kmap.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k_vol", [8, 27])
@pytest.mark.parametrize("f_in,f_out", [(256, 256), (512, 512), (256, 512), (128, 32),
                                        (32, 96), (100, 64)])
def test_gather_conv_cuda_wide_and_mixed(cuda, k_vol, f_in, f_out):
    """Widths to 512, F_in != F_out, 64- and 32-column slices, F_in in
    several 64-column chunks with a ragged one; bit-equal on repeat."""
    gen = np.random.default_rng(f_in * f_out + k_vol)
    b, c, n_valid = 2, 700, 600
    feats = torch.from_numpy(gen.standard_normal((b, c, f_in)).astype(np.float32)).to(cuda)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, k_vol, c, c, n_valid)).to(cuda)
    kernel = torch.from_numpy((gen.standard_normal((k_vol, f_in, f_out)) / np.sqrt(f_in))
                              .astype(np.float32)).to(cuda)
    epi = _epi(gen, f_out, b, c, cuda)
    got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
    assert _rel_err(got, kernels.gather_conv_plain(feats, kmap, kernel, epi=epi)) <= REL_TOL
    assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)


@pytest.mark.cuda
def test_gather_conv_cuda_deep_level(cuda):
    """A deep level: 8 clouds with 18 of 1,024 voxels each, one occupied
    64-row tile per cloud, 128 x 128 at K = 27."""
    gen = np.random.default_rng(7)
    b, c, n_valid, k_vol, f = 8, 1024, 18, 27, 128
    feats = np.zeros((b, c, f), np.float32)
    feats[:, :n_valid] = gen.standard_normal((b, n_valid, f))
    feats = torch.from_numpy(feats).to(cuda)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, k_vol, c, c, n_valid, 0.5)).to(cuda)
    kernel = torch.from_numpy(gen.standard_normal((k_vol, f, f)).astype(np.float32)).to(cuda)
    got = kernels.gather_conv(feats, kmap, kernel)
    assert _rel_err(got, kernels.gather_conv_plain(feats, kmap, kernel)) <= REL_TOL
    assert float(got[:, 64:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", [(32, 32), (128, 128), (256, 256), (512, 512),
                                        (256, 512), (64, 128)])
def test_tdown_cuda_matches_plain(cuda, f_in, f_out):
    gen = np.random.default_rng(f_in)
    b, c_fine, c_coarse = 2, 3000, 1100
    parent = np.full((b, c_fine), c_coarse, np.int32)
    slot = gen.integers(0, 8, size=(b, c_fine)).astype(np.int32)
    for i in range(b):
        cells = gen.choice(8 * c_coarse, 2500, replace=False)
        rows = gen.choice(c_fine, 2500, replace=False)
        parent[i, rows], slot[i, rows] = cells % c_coarse, cells // c_coarse
    feats = torch.from_numpy(gen.standard_normal((b, c_fine, f_in)).astype(np.float32)).to(cuda)
    kernel = torch.from_numpy(gen.standard_normal((8, f_in, f_out)).astype(np.float32)).to(cuda)
    args = (feats, torch.from_numpy(parent).to(cuda), torch.from_numpy(slot).to(cuda), kernel,
            c_coarse)
    for epi in (None, _epi(gen, f_out, b, c_coarse, cuda)):
        got = kernels.tdown(*args, epi=epi)
        assert _rel_err(got, kernels.tdown_plain(*args, epi=epi)) <= REL_TOL
        assert torch.equal(kernels.tdown(*args, epi=epi), got)


def _full_pyramid(kind, device):
    """The forward's (EgoNN, 8 x 65,536 lidar_sim points, cap0 16384) or
    MinkLoc's (minkloc3d_mulran.txt, cap0 40960) pyramid on the card, with
    the widths of each level's down conv."""
    import pathlib

    from egonn_tpu_torch.config import ModelParams
    from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.ops.quantization import PolarQuantizer
    from egonn_tpu_torch.sparse import pyramid as tpyr

    clouds = torch.from_numpy(lidar_scan_clouds(8, 65536, seed=0)).to(device)
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool, device=device)
    if kind == "egonn":
        quantizer, spec = PolarQuantizer([1.0, 0.3, 0.2]), tpyr.egonn_pyramid_spec(cap0=16384)
        widths = [(32, 32), (32, 32), (64, 64), (64, 64), (128, 128), (128, 128), (128, 128)]
    else:
        root = pathlib.Path(__file__).resolve().parents[1]
        mp = ModelParams(str(root / "model_configs" / "minkloc3d_mulran.txt"))
        built = model_factory(mp, cap0=40960, device="cpu")
        quantizer, spec = built.quantizer, built.pyramid_spec
        widths = [(32, 32), (32, 32), (64, 64)]
    res = quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
    return tpyr.build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys), spec, widths


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["egonn", "minkloc"])
def test_tdown_cuda_at_pyramid_levels(cuda, kind):
    """Every down conv of the EgoNN forward and of MinkLoc's, on their real
    up maps and widths, with and without the epilogue; bit-equal repeats."""
    pyr, spec, widths = _full_pyramid(kind, cuda)
    gen = np.random.default_rng(11)
    for l, (f_in, f_out) in zip(spec.up_levels, widths):
        b, c_fine = pyr[l].up_parent.shape
        c_coarse = spec.capacities[l + 1]
        feats = torch.from_numpy(gen.standard_normal((b, c_fine, f_in)).astype(np.float32))
        kernel = torch.from_numpy((gen.standard_normal((8, f_in, f_out)) / np.sqrt(f_in))
                                  .astype(np.float32))
        args = (feats.to(cuda), pyr[l].up_parent, pyr[l].up_koffset, kernel.to(cuda), c_coarse)
        for rows in (32, 64, 128):
            assert torch.equal(kernels._tdown_hulls_cuda(pyr[l].up_parent, c_coarse, rows),
                               kernels.tdown_hulls_plain(pyr[l].up_parent, c_coarse, rows))
        for epi in (None, _epi(gen, f_out, b, c_coarse, cuda)):
            got = kernels.tdown(*args, epi=epi)
            assert _rel_err(got, kernels.tdown_plain(*args, epi=epi)) <= REL_TOL, f"L{l}"
            assert torch.equal(kernels.tdown(*args, epi=epi), got)


def _edge_up_map(case, gen, b, c_fine, c_coarse):
    """Up maps at the edges of the tdown kernel's design."""
    parent = np.full((b, c_fine), c_coarse, np.int32)
    slot = gen.integers(0, 8, size=(b, c_fine)).astype(np.int32)
    if case == "full":  # every parent below c_fine // 8 has all 8 children, in slot order
        p = np.arange(c_fine) // 8
        parent[:] = np.where(p < c_coarse, p, c_coarse)
        slot[:] = np.arange(c_fine) % 8
    elif case in ("dropped", "shuffled", "tiles"):
        cells = np.sort([gen.choice(8 * c_coarse, c_fine, replace=False) for _ in range(b)],
                        axis=1)
        parent[:], slot[:] = cells // 8, cells % 8
        if case == "dropped":  # parents dropped by capacity: runs and scattered rows
            parent[:, c_fine // 3: c_fine // 2] = c_coarse
            parent[gen.random((b, c_fine)) < 0.2] = c_coarse
        elif case == "shuffled":  # hulls span the table
            order = gen.permutation(c_fine)
            parent[:], slot[:] = parent[:, order], slot[:, order]
        else:  # whole empty tiles between occupied ones
            parent[(parent // 64) % 3 == 1] = c_coarse
    # case "empty": no fine row has a parent
    return parent, slot


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "full", "dropped", "shuffled", "tiles"])
@pytest.mark.parametrize("f_in,f_out", [(32, 32), (128, 128), (36, 64)])
def test_tdown_cuda_edge_cases(cuda, case, f_in, f_out):
    """Empty tiles and tables, parents with all 8 children, children whose
    parent was dropped by capacity, shuffled parents, each with and without
    the epilogue, at every tiling the kernel takes; bit-equal repeats."""
    gen = np.random.default_rng(f_in + len(case))
    b, c_fine, c_coarse = 3, 2000, 700
    parent, slot = _edge_up_map(case, gen, b, c_fine, c_coarse)
    feats = torch.from_numpy(gen.standard_normal((b, c_fine, f_in)).astype(np.float32)).to(cuda)
    kernel = torch.from_numpy(gen.standard_normal((8, f_in, f_out)).astype(np.float32)).to(cuda)
    args = (feats, torch.from_numpy(parent).to(cuda), torch.from_numpy(slot).to(cuda), kernel,
            c_coarse)
    for rows in (32, 64, 128):  # the first launch alone: the hulls
        assert torch.equal(kernels._tdown_hulls_cuda(args[1], c_coarse, rows),
                           kernels.tdown_hulls_plain(args[1], c_coarse, rows))
    for epi in (None, _epi(gen, f_out, b, c_coarse, cuda)):
        want = kernels.tdown_plain(*args, epi=epi)
        tilings = [(128, 0, True)] + [(rows, rc, False) for rows, rc in
                                      itertools.product((32, 64, 128), (32, 128))]
        for tiling in tilings:  # both bodies
            if not kernels.tdown_tiling_ok(f_in, f_out, *tiling):
                continue
            got = kernels._tdown_cuda(*args, epi, *tiling)
            assert _rel_err(got, want) <= REL_TOL, tiling
            assert torch.equal(kernels._tdown_cuda(*args, epi, *tiling), got)
        if case == "empty" and epi is None:
            assert float(kernels.tdown(*args).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k_vol", [8, 27])
@pytest.mark.parametrize("f_in,f_out", [(32, 32), (32, 64), (64, 128), (128, 128), (128, 32),
                                        (256, 256), (512, 32), (96, 160)])
def test_gather_dw_cuda_matches_plain(cuda, k_vol, f_in, f_out):
    gen = np.random.default_rng(f_in + f_out + k_vol)
    b, c_in, c_out = 3, 1000, 777  # a ragged last tile
    feats = torch.from_numpy(gen.standard_normal((b, c_in, f_in)).astype(np.float32)).to(cuda)
    kmap = gen.integers(0, c_in, size=(b, k_vol, c_out))
    kmap = np.where(gen.random((b, k_vol, c_out)) < 0.6, c_in, kmap).astype(np.int32)
    kmap[:, :, 500:] = c_in  # whole tiles of sentinels
    kmap[1, 3, 10] = -5      # out of range: a zero row
    kmap = torch.from_numpy(kmap).to(cuda)
    g = torch.from_numpy(gen.standard_normal((b, c_out, f_out)).astype(np.float32)).to(cuda)
    before = kernels.launch_counts()["gather_dw"]
    got = kernels.gather_dw(feats, kmap, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_dw"] == before + 1
    want = kernels.gather_dw_plain(feats, kmap, g)
    assert got.shape == (k_vol, f_in, f_out)
    assert _rel_err(got, want) <= DW_REL_TOL
    # deterministic: no atomics, a fixed summation order
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kz", [3, 5])
def test_zrun_cuda_matches_plain(cuda, kz):
    gen = np.random.default_rng(kz)
    keys = _sorted_keys(gen, 3, 4096, 3000, 20000)
    q = _queries(gen, keys, (3, kz * kz, 3000), 20000)
    keys_t, q_t = torch.from_numpy(keys).to(cuda), torch.from_numpy(q).to(cuda)
    bits, rank = kernels.zrun_rank(keys_t, q_t, kz)
    want_bits, want_rank = kernels.zrun_plain(keys_t, q_t, kz)
    assert torch.equal(bits, want_bits) and torch.equal(rank, want_rank)
    assert torch.equal(kernels.zrun_presence(keys_t, q_t, kz), want_bits)


def _sorted_rows(gen, keys, shape, kz):
    """Queries as `_zrun_queries` gives them: each row sorted over its valid
    entries, near the table's keys, with MAXKEY holes mid-row and a tail
    past the last key."""
    b = keys.shape[0]
    q = np.empty(shape, np.int64)
    for i in range(b):
        valid = keys[i][keys[i] != MAXKEY].astype(np.int64)
        for r in range(shape[1]):
            q[i, r] = np.sort(gen.choice(valid, shape[2]) + gen.integers(-kz, 2, shape[2]))
    q[:, :, -40:] = keys[keys != MAXKEY].max() + np.arange(1, 41)  # past the last key
    q[gen.random(shape) < 0.15] = MAXKEY                          # holes mid-row
    q[0, 0] = MAXKEY                                              # an all-invalid row
    return np.clip(q, 0, MAXKEY).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kz", [3, 5])
@pytest.mark.parametrize("q_chunk", [256, 512, 1024, 100])
def test_zrun_cuda_chunks(cuda, kz, q_chunk):
    """Sorted rows with MAXKEY holes and queries past the last key, rows not
    a multiple of the chunk: every chunk's slice fits, bit-equal to the plain
    version and on repeat.  Shuffled rows spread a chunk over the table: its
    blocks search the global table (counted), still exact."""
    gen = np.random.default_rng(kz * q_chunk)
    keys = _sorted_keys(gen, 3, 5000, 4200, 40000)
    q = _sorted_rows(gen, keys, (3, kz * kz, 2999), kz)
    keys_t = torch.from_numpy(keys).to(cuda)
    for shuffled in (False, True):
        rows = gen.permuted(q, axis=2) if shuffled else q
        q_t = torch.from_numpy(np.ascontiguousarray(rows)).to(cuda)
        want_bits, want_rank = kernels.zrun_plain(keys_t, q_t, kz)
        before = kernels.zrun_overflow_blocks(cuda)
        bits, rank = kernels._zrun_cuda(keys_t, q_t, kz, True, q_chunk)
        presence = kernels._zrun_cuda(keys_t, q_t, kz, False, q_chunk)
        torch.cuda.synchronize()
        overflow = kernels.zrun_overflow_blocks(cuda) - before
        assert torch.equal(bits, want_bits) and torch.equal(rank, want_rank)
        assert torch.equal(presence, want_bits)
        again = kernels._zrun_cuda(keys_t, q_t, kz, True, q_chunk)
        assert torch.equal(again[0], bits) and torch.equal(again[1], rank)
        assert (overflow > 0) == shuffled, overflow


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,n_valid", [(1000, (700, 0, 1000)), (40960, (29000, 40960, 3))])
def test_lookup_cuda_matches_plain(cuda, c_in, n_valid):
    """Partly filled, empty and full tables; a third of the queries absent or
    invalid."""
    gen = np.random.default_rng(c_in)
    keys = np.full((3, c_in), MAXKEY, np.int32)
    for i, n in enumerate(n_valid):
        keys[i, :n] = np.sort(gen.choice(4 * c_in, n, replace=False))
    q = _queries(gen, keys, (3, 8, 777), 4 * c_in)
    keys, q = torch.from_numpy(keys).to(cuda), torch.from_numpy(q).to(cuda)
    before = kernels.launch_counts()["lookup"]
    got = kernels.lookup(keys, q)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lookup"] == before + 1
    assert torch.equal(got, kernels.lookup_plain(keys, q))
    assert int((got < c_in).sum()) > 0 and int((got == c_in).sum()) > 0


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_inputs(cuda):
    feats = torch.zeros(1, 64, 32, device=cuda)
    kmap = torch.zeros(1, 27, 64, dtype=torch.int32, device=cuda)
    kernel = torch.zeros(27, 32, 32, device=cuda)
    with pytest.raises(TypeError):
        kernels.gather_conv(feats.double(), kmap, kernel.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather_conv(feats.transpose(1, 2).contiguous().transpose(1, 2), kmap, kernel)
    with pytest.raises(ValueError, match="F_in"):  # feats and kernel disagree
        kernels.gather_conv(feats, kmap, torch.zeros(27, 16, 48, device=cuda))
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        kernels.gather_conv(feats, kmap.cpu(), kernel)
    with pytest.raises(ValueError, match="gather_dw"):  # the kernel alone takes 32-multiples
        kernels._gather_dw_cuda(torch.zeros(1, 64, 16, device=cuda), kmap,
                                torch.zeros(1, 64, 32, device=cuda))
    with pytest.raises(ValueError, match="kz"):
        kernels.zrun_rank(torch.zeros(1, 8, dtype=torch.int32, device=cuda),
                          torch.zeros(1, 1, 8, dtype=torch.int32, device=cuda), 9)
    keys = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="queries"):
        kernels.lookup(keys, torch.zeros(1, 8, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        kernels.lookup(keys.long(), torch.zeros(1, 2, 8, dtype=torch.int64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out,k_vol", [(1, 64, 125), (3, 64, 27), (32, 48, 27),
                                              (1024, 1024, 8), (600, 40, 8)])
def test_conv_cuda_planned_widths(cuda, f_in, f_out, k_vol):
    """gather_conv and tdown at widths the kernels take only through the
    width plan (F_in 1 and 3 padded, F_out 48 padded, 1024 split both ways),
    with and without the epilogue: within rel 1e-5 of the plain versions,
    one launch per chunk pair, bit-equal on repeat."""
    gen = np.random.default_rng(f_in * 7 + f_out + k_vol)
    b, c_in, c_out = 2, 900, 700
    plan = kernels.width_plan(f_in, f_out)
    n_launch = len(plan.in_chunks) * len(plan.out_chunks)
    feats = torch.from_numpy(gen.standard_normal((b, c_in, f_in)).astype(np.float32)).to(cuda)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, k_vol, c_in, c_out, 600)).to(cuda)
    kernel = torch.from_numpy((gen.standard_normal((k_vol, f_in, f_out)) / np.sqrt(f_in))
                              .astype(np.float32)).to(cuda)
    for epi in (None, _epi(gen, f_out, b, c_out, cuda)):
        before = kernels.launch_counts()["gather_conv"]
        got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
        assert kernels.launch_counts()["gather_conv"] == before + n_launch
        assert got.shape == (b, c_out, f_out) and got.is_contiguous()
        assert _rel_err(got, kernels.gather_conv_plain(feats, kmap, kernel, epi=epi)) <= REL_TOL
        assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)
    if k_vol != 8:
        return
    parent = np.full((b, c_in), c_out, np.int32)
    slot = gen.integers(0, 8, size=(b, c_in)).astype(np.int32)
    for i in range(b):
        cells = gen.choice(8 * c_out, 800, replace=False)
        rows = gen.choice(c_in, 800, replace=False)
        parent[i, rows], slot[i, rows] = cells % c_out, cells // c_out
    args = (feats, torch.from_numpy(parent).to(cuda), torch.from_numpy(slot).to(cuda), kernel,
            c_out)
    for epi in (None, _epi(gen, f_out, b, c_out, cuda)):
        before = kernels.launch_counts()["tdown"]
        got = kernels.tdown(*args, epi=epi)
        assert kernels.launch_counts()["tdown"] == before + n_launch
        assert _rel_err(got, kernels.tdown_plain(*args, epi=epi)) <= REL_TOL
        assert torch.equal(kernels.tdown(*args, epi=epi), got)


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", [(1, 64), (3, 48), (1024, 1024), (48, 600)])
def test_gather_dw_cuda_planned_widths(cuda, f_in, f_out):
    """gather_dw at widths it takes only through the plan: within 1e-4 x
    max |plain| and bit-equal on repeat."""
    gen = np.random.default_rng(f_in + 3 * f_out)
    b, c_in, c_out, k_vol = 2, 900, 700, 8
    feats = torch.from_numpy(gen.standard_normal((b, c_in, f_in)).astype(np.float32)).to(cuda)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, k_vol, c_in, c_out, 600)).to(cuda)
    g = torch.from_numpy(gen.standard_normal((b, c_out, f_out)).astype(np.float32)).to(cuda)
    got = kernels.gather_dw(feats, kmap, g)
    assert got.shape == (k_vol, f_in, f_out) and got.is_contiguous()
    assert _rel_err(got, kernels.gather_dw_plain(feats, kmap, g)) <= DW_REL_TOL
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)


def _dw_bf16_case(gen, b, c_in, c_out, k_vol, f_in, f_out, cuda, n_valid=None):
    """bf16 features and g with a sparse map (ragged last tile, whole tiles of
    sentinels, one out-of-range index)."""
    feats = _bf16(gen, (b, c_in, f_in), cuda)
    kmap = _sparse_kmap(gen, b, k_vol, c_in, c_out, n_valid or min(c_in, c_out) * 2 // 3)
    kmap[-1, 0, 0] = -5
    g = _bf16(gen, (b, c_out, f_out), cuda)
    return feats, torch.from_numpy(kmap).to(cuda), g


@pytest.mark.cuda
@pytest.mark.parametrize("k_vol", [8, 27])
@pytest.mark.parametrize("f_in,f_out", [(32, 32), (32, 64), (64, 128), (128, 128), (128, 32),
                                        (256, 256), (512, 32), (96, 160), (512, 512)])
def test_gather_dw_bf16_cuda_matches_plain(cuda, k_vol, f_in, f_out):
    """bf16 features take the bf16 dW kernel (its own launch count, the
    split-TF32 count untouched): f32 dW within 1e-4 x max |plain| of the
    bf16 plain version (both sum the exact products in f32, in another
    order) at widths 32-512 through the width plan, K 8 and 27; an f32 g is
    rounded by the wrapper (equal to passing it in bf16); bit-equal on
    repeat."""
    gen = np.random.default_rng(f_in + 7 * f_out + k_vol)
    feats, kmap, g = _dw_bf16_case(gen, 3, 1000, 777, k_vol, f_in, f_out, cuda)
    before = kernels.launch_counts()
    got = kernels.gather_dw(feats, kmap, g)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gather_dw_bf16"] == before["gather_dw_bf16"] + 1
    assert after["gather_dw"] == before["gather_dw"]
    assert got.dtype == torch.float32 and got.shape == (k_vol, f_in, f_out)
    assert _rel_err(got, kernels.gather_dw_plain(feats, kmap, g)) <= DW_REL_TOL
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)
    assert torch.equal(kernels.gather_dw(feats, kmap, g.float()), got)


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", [(1, 64), (48, 600), (1024, 64)])
def test_gather_dw_bf16_cuda_planned_widths(cuda, f_in, f_out):
    """bf16 dW at widths the kernel takes only through the plan (zero padding,
    512-wide splits, each chunk's f32 sums whole): within 1e-4 x max |plain|,
    one launch counted per chunk pair."""
    gen = np.random.default_rng(f_in + 5 * f_out)
    feats, kmap, g = _dw_bf16_case(gen, 2, 900, 700, 8, f_in, f_out, cuda, n_valid=600)
    plan = kernels.width_plan(f_in, f_out, dw=True)
    before = kernels.launch_counts()["gather_dw_bf16"]
    got = kernels.gather_dw(feats, kmap, g)
    assert kernels.launch_counts()["gather_dw_bf16"] == before + len(plan.in_chunks) * len(
        plan.out_chunks)
    assert got.dtype == torch.float32 and got.shape == (8, f_in, f_out) and got.is_contiguous()
    assert _rel_err(got, kernels.gather_dw_plain(feats, kmap, g)) <= DW_REL_TOL
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["deep", "sentinel", "full"])
def test_gather_dw_bf16_cuda_edge_cases(cuda, case):
    """A deep level's single occupied tile (one cloud of 40 with 3 voxels,
    the rest empty), an all-sentinel map (dW exactly 0), and a full map
    (every row valid at every offset: 64-row tiles of depth 64); bit-equal
    repeats."""
    gen = np.random.default_rng(11)
    if case == "deep":
        b, c, f, k_vol = 40, 128, 128, 27
        feats = torch.zeros(b, c, f, dtype=torch.bfloat16, device=cuda)
        feats[7, :3] = _bf16(gen, (3, f), cuda)
        kmap = np.full((b, k_vol, c), c, np.int32)
        kmap[7, :, :3] = gen.integers(0, 3, (k_vol, 3))
        kmap = torch.from_numpy(kmap).to(cuda)
        g = torch.zeros(b, c, f, dtype=torch.bfloat16, device=cuda)
        g[7, :3] = _bf16(gen, (3, f), cuda)
    else:
        b, c, f, k_vol = 2, 500, 64, 8
        feats, g = _bf16(gen, (b, c, f), cuda), _bf16(gen, (b, c, f), cuda)
        fill = np.full((b, k_vol, c), c) if case == "sentinel" else gen.integers(0, c,
                                                                                  (b, k_vol, c))
        kmap = torch.from_numpy(fill.astype(np.int32)).to(cuda)
    got = kernels.gather_dw(feats, kmap, g)
    want = kernels.gather_dw_plain(feats, kmap, g)
    if case == "sentinel":
        assert float(got.abs().max()) == 0.0
    else:
        assert _rel_err(got, want) <= DW_REL_TOL and float(want.abs().max()) > 0.1
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)


def _down_pyramid(gen, case, b=3, n=3000, caps=(2048, 1024, 512)):
    """Sorted keys of three levels (fine to coarse) under the default
    packing and its halvings, each level the unique halved keys of the one
    below capped at its capacity: cloud 0 empty, cloud 1 a single voxel,
    cloud 2 n random points.  `dropped`: each coarse level is built from the
    uncapped finer set, so children past the finer capacity are absent."""
    from egonn_tpu_torch.sparse.packing import DEFAULT_PACK, halved_spec, pack_keys

    packs = [DEFAULT_PACK]
    for _ in caps[1:]:
        packs.append(halved_spec(packs[-1]))
    keys = [np.full((b, c), MAXKEY, np.int64) for c in caps]
    for i, n_pts in enumerate((0, 1, n)):
        pts = np.stack([gen.integers(-60, 60, n_pts), gen.integers(-60, 60, n_pts),
                        gen.integers(-8, 8, n_pts)])
        coords = torch.from_numpy(pts.astype(np.int32))
        full = np.unique(pack_keys(coords, torch.ones(n_pts, dtype=torch.bool),
                                   packs[0]).numpy())
        for l, cap in enumerate(caps):
            keys[l][i, :min(cap, full.size)] = full[:cap]
            src = full if case == "dropped" else keys[l][i][keys[l][i] != MAXKEY]
            if l + 1 < len(caps):
                half = np.stack([(np.asarray(src) >> s) & ((1 << w) - 1) for s, w in
                                 ((21, 10), (11, 10), (0, 11))])
                half = half >> 1
                full = np.unique((half[0] << 21) | (half[1] << 11) | half[2])
    return [torch.from_numpy(k.astype(np.int32)) for k in keys], packs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["capped", "dropped"])
def test_lookup_down_cuda_matches_plain(cuda, case):
    """The grouped lookup (levels 1 and 2 in one launch) against
    `lookup_down_plain`: an empty cloud, a single voxel, children dropped by
    the finer capacity; bit-equal on repeat, no overflow at the rule's
    slice, and with a 16-row slice every occupied block overflows (counted)
    and the result stays exact."""
    gen = np.random.default_rng(len(case))
    keys, packs = _down_pyramid(gen, case)
    keys = [k.to(cuda) for k in keys]
    want = kernels.lookup_down_plain(keys, packs, [1, 2])
    before, over = kernels.launch_counts()["lookup"], kernels.lookup_overflow_blocks(cuda)
    got = kernels.lookup_down(keys, packs, [1, 2])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lookup"] == before + 1
    assert kernels.lookup_overflow_blocks(cuda) == over
    for g, w, c in zip(got, want, (2048, 1024)):
        assert g.shape == w.shape and torch.equal(g, w)
        assert int((g < c).sum()) > 0 and int((g[0] < c).sum()) == 0
        assert int((g[1] < c).sum()) == 1
    assert all(torch.equal(a, g) for a, g in zip(kernels.lookup_down(keys, packs, [1, 2]), got))
    src = [keys[1], keys[2]]
    tight = kernels._lookup_cuda([keys[0], keys[1]], src, [8, 8],
                                 [(packs[1], packs[0]), (packs[2], packs[1])], slice_cap=16)
    torch.cuda.synchronize()
    assert kernels.lookup_overflow_blocks(cuda) > over
    assert all(torch.equal(a, g) for a, g in zip(tight, got))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32, 128, 256])
def test_lookup_cuda_unsorted_queries(cuda, rows):
    """Mode (a) on shuffled queries at several tile heights: exact, and
    spread tiles overflow a small slice (counted) without changing the
    result."""
    gen = np.random.default_rng(rows)
    keys = _sorted_keys(gen, 2, 5000, 4200, 40000)
    q = _queries(gen, keys, (2, 8, 3000), 40000)
    keys_t, q_t = torch.from_numpy(keys).to(cuda), torch.from_numpy(q).to(cuda)
    want = kernels.lookup_plain(keys_t, q_t)
    for cap in (4096, 64):
        got = kernels._lookup_cuda([keys_t], [q_t], [8], None, rows=rows, slice_cap=cap)[0]
        assert torch.equal(got, want), cap


def _one_bf16_ulp(got, want):
    """bf16 outputs within one bf16 ulp of the plain version's, or within
    BF16_ABS_TOL x max |plain|."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    near = (got.float() - want.float()).abs() <= BF16_ABS_TOL * float(want.float().abs().max())
    ulps = kernels.bf16_ulps(got, want)
    assert bool(((ulps <= 1) | near).all()), int(ulps[~near].max())


def _bf16(gen, shape, device, scale=1.0):
    return torch.from_numpy((gen.standard_normal(shape) * scale).astype(np.float32)).to(
        device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", [(8, 32), (40, 64), (64, 128), (128, 128), (128, 32),
                                        (32, 96)])
@pytest.mark.parametrize("k_vol", [8, 27])
@pytest.mark.parametrize("with_epi", [False, True])
def test_gather_conv_bf16_cuda_matches_plain(cuda, f_in, f_out, k_vol, with_epi):
    """bf16 features take the bf16 kernel (its own launch count, the f32
    count untouched): within one ulp of the bf16 plain version at F_in 8-128,
    F_out 32-128, K 8 and 27, ragged tiles and whole tiles of sentinels;
    bit-equal on repeat."""
    gen = np.random.default_rng(f_in * f_out + k_vol)
    b, c_in, c_out = 3, 1000, 777
    feats = _bf16(gen, (b, c_in, f_in), cuda)
    kmap = np.where(gen.random((b, k_vol, c_out)) < 0.6, c_in,
                    gen.integers(0, c_in, size=(b, k_vol, c_out))).astype(np.int32)
    kmap[:, :, 500:] = c_in
    kmap = torch.from_numpy(kmap).to(cuda)
    kernel = torch.from_numpy((gen.standard_normal((k_vol, f_in, f_out)) / np.sqrt(f_in))
                              .astype(np.float32)).to(cuda)
    epi = _epi(gen, f_out, b, c_out, cuda) if with_epi else None
    before = kernels.launch_counts()
    got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["gather_conv_bf16"] == before["gather_conv_bf16"] + 1
    assert after["gather_conv"] == before["gather_conv"]
    _one_bf16_ulp(got, kernels.gather_conv_plain(feats, kmap, kernel, epi=epi))
    if not with_epi:
        assert float(got[:, 512:].float().abs().max()) == 0.0
    assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)


@pytest.mark.cuda
@pytest.mark.parametrize("with_epi", [False, True])
def test_gather_conv_bf16_cuda_offset_groups(cuda, with_epi):
    """A deep level's small grid (8 clouds, one occupied tile each, 128 x
    128 at K = 27): the offsets split over blocks, the f32 partial sums added
    in order by the second launch, then the epilogue and the one rounding."""
    gen = np.random.default_rng(17)
    b, c, n_valid, k_vol, f = 8, 1024, 18, 27, 128
    assert kernels.offset_groups(b, c, f, f, k_vol) > 1
    feats = np.zeros((b, c, f), np.float32)
    feats[:, :n_valid] = gen.standard_normal((b, n_valid, f))
    feats = torch.from_numpy(feats).to(cuda, torch.bfloat16)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, k_vol, c, c, n_valid, 0.5)).to(cuda)
    kernel = torch.from_numpy((gen.standard_normal((k_vol, f, f)) / np.sqrt(f))
                              .astype(np.float32)).to(cuda)
    epi = _epi(gen, f, b, c, cuda) if with_epi else None
    got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
    _one_bf16_ulp(got, kernels.gather_conv_plain(feats, kmap, kernel, epi=epi))
    assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "full", "dropped", "shuffled", "tiles"])
@pytest.mark.parametrize("f_in,f_out", [(8, 32), (32, 32), (40, 64), (128, 128)])
def test_tdown_bf16_cuda_edge_cases(cuda, case, f_in, f_out):
    """The bf16 tdown bodies on test_tdown_cuda_edge_cases's up maps, at
    every tiling they take, with and without the epilogue: within one ulp
    of the bf16 plain version, bit-equal on repeat."""
    gen = np.random.default_rng(f_in + 3 * len(case))
    b, c_fine, c_coarse = 3, 2000, 700
    parent, slot = _edge_up_map(case, gen, b, c_fine, c_coarse)
    feats = _bf16(gen, (b, c_fine, f_in), cuda)
    kernel = torch.from_numpy((gen.standard_normal((8, f_in, f_out)) / np.sqrt(f_in))
                              .astype(np.float32)).to(cuda)
    args = (feats, torch.from_numpy(parent).to(cuda), torch.from_numpy(slot).to(cuda), kernel,
            c_coarse)
    tilings = [(128, 0, True)] + [(rows, rc, False) for rows, rc in
                                  itertools.product((32, 64, 128), (32, 64, 128))]
    for epi in (None, _epi(gen, f_out, b, c_coarse, cuda)):
        want = kernels.tdown_plain(*args, epi=epi)
        for tiling in tilings:
            assert kernels.tdown_tiling_ok(f_in, f_out, *tiling, bf16=True)
            got = kernels._tdown_cuda(*args, epi, *tiling)
            _one_bf16_ulp(got, want)
            assert torch.equal(kernels._tdown_cuda(*args, epi, *tiling), got)
    before = kernels.launch_counts()
    kernels.tdown(*args)
    after = kernels.launch_counts()
    assert (after["tdown_bf16"], after["tdown"]) == (before["tdown_bf16"] + 1, before["tdown"])


@pytest.mark.cuda
def test_tdown_bf16_cuda_at_pyramid_levels(cuda):
    """Every down conv of the EgoNN forward on its real up maps and widths,
    bf16 features: within one ulp of the bf16 plain version."""
    pyr, spec, widths = _full_pyramid("egonn", cuda)
    gen = np.random.default_rng(13)
    for l, (f_in, f_out) in zip(spec.up_levels, widths):
        b, c_fine = pyr[l].up_parent.shape
        c_coarse = spec.capacities[l + 1]
        feats = _bf16(gen, (b, c_fine, f_in), cuda)
        kernel = torch.from_numpy((gen.standard_normal((8, f_in, f_out)) / np.sqrt(f_in))
                                  .astype(np.float32)).to(cuda)
        args = (feats, pyr[l].up_parent, pyr[l].up_koffset, kernel, c_coarse)
        for epi in (None, _epi(gen, f_out, b, c_coarse, cuda)):
            got = kernels.tdown(*args, epi=epi)
            _one_bf16_ulp(got, kernels.tdown_plain(*args, epi=epi))
            assert torch.equal(kernels.tdown(*args, epi=epi), got)


@pytest.mark.cuda
def test_conv_bf16_cuda_planned_widths_and_refusals(cuda):
    """bf16 at widths the kernels take only through the plan (F_in 3 padded
    to 8, F_out 48 to 64) within one ulp; F_in above 512 raises, and so does
    gather_dw on f16 features or on bf16 features with an f16 g."""
    gen = np.random.default_rng(5)
    b, c_in, c_out = 2, 900, 700
    feats = _bf16(gen, (b, c_in, 3), cuda)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, 27, c_in, c_out, 600)).to(cuda)
    kernel = torch.from_numpy(gen.standard_normal((27, 3, 48)).astype(np.float32)).to(cuda)
    got = kernels.gather_conv(feats, kmap, kernel)
    assert got.shape == (b, c_out, 48) and got.dtype == torch.bfloat16
    _one_bf16_ulp(got, kernels.gather_conv_plain(feats, kmap, kernel))
    with pytest.raises(ValueError, match="F_in"):
        kernels.gather_conv(_bf16(gen, (b, c_in, 600), cuda), kmap,
                            torch.zeros(27, 600, 32, device=cuda))
    with pytest.raises(TypeError):
        kernels.gather_dw(feats.half(), kmap, torch.zeros(b, c_out, 32, device=cuda,
                                                          dtype=torch.float16))
    with pytest.raises(TypeError):
        kernels._gather_dw_cuda(_bf16(gen, (b, c_in, 32), cuda), kmap,
                                torch.zeros(b, c_out, 32, device=cuda, dtype=torch.float16))


# The bf16 conv and dW bodies (kernels.SM90: wgmma on shared-memory tiles fed
# by an mbarrier ring; kernels.SM80: mma.sync behind a barrier per stage),
# each forced for every call: both stay tested whichever the rules pick.
_BODIES = {"sm90": kernels.SM90, "sm80": kernels.SM80}


def _force_body(monkeypatch, body):
    for rule in ("conv_body", "dw_body"):
        monkeypatch.setattr(kernels, rule, lambda *shape: _BODIES[body])


def _runs_kmap(gen, b, k_vol, c_in, c_out, n_run):
    """Rows 0-127 of each cloud: every offset valid at exactly n_run rows
    (a random subset, sources anywhere); rows 128-255: every offset empty;
    rows from 256 (a ragged last tile): about a third valid."""
    kmap = np.full((b, k_vol, c_out), c_in, np.int64)
    for bi in range(b):
        for k in range(k_vol):
            rows = gen.choice(128, size=n_run, replace=False)
            kmap[bi, k, rows] = gen.integers(0, c_in, n_run)
    tail = gen.random((b, k_vol, c_out - 256)) < 0.33
    kmap[:, :, 256:] = np.where(tail, gen.integers(0, c_in, tail.shape), c_in)
    return kmap.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(_BODIES))
@pytest.mark.parametrize("n_run", [1, 8, 63, 64, 65, 128])
@pytest.mark.parametrize("k_vol,f_in,f_out", [(27, 32, 32), (8, 64, 64), (27, 128, 128),
                                              (8, 32, 96), (27, 128, 32)])
def test_gather_conv_bf16_cuda_stage_runs(cuda, monkeypatch, body, n_run, k_vol, f_in, f_out):
    """Runs of exactly n_run valid rows an offset in a tile (65 and 128: an
    offset's rows span two stages of the SM90 body, whose stages hold 64), a
    tile with every offset empty (its rows exactly epi(0)), a ragged last
    tile (C_out = 300, not a multiple of 128), with and without the
    epilogue: within one ulp of the plain version, bit-equal on repeat."""
    _force_body(monkeypatch, body)
    gen = np.random.default_rng(n_run * 31 + k_vol + f_in + f_out)
    b, c_in, c_out = 2, 500, 300
    feats = _bf16(gen, (b, c_in, f_in), cuda)
    kmap = torch.from_numpy(_runs_kmap(gen, b, k_vol, c_in, c_out, n_run)).to(cuda)
    kernel = torch.from_numpy((gen.standard_normal((k_vol, f_in, f_out)) / np.sqrt(f_in))
                              .astype(np.float32)).to(cuda)
    for epi in (None, _epi(gen, f_out, b, c_out, cuda)):
        got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
        want = kernels.gather_conv_plain(feats, kmap, kernel, epi=epi)
        _one_bf16_ulp(got, want)
        assert torch.equal(got[:, 128:256], want[:, 128:256])  # the empty tile: epi(0)
        assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(_BODIES))
@pytest.mark.parametrize("f_in,f_out", [(512, 512), (256, 1024), (40, 64)])
def test_gather_conv_bf16_cuda_body_widths(cuda, monkeypatch, body, f_in, f_out):
    """512-wide bf16 convs on one launch, 1024 output columns through the
    width plan (two launches), and F_in not a multiple of 16 (a 16-deep
    step half past F_in): within one ulp, bit-equal on repeat."""
    _force_body(monkeypatch, body)
    gen = np.random.default_rng(f_in + f_out)
    b, c_in, c_out = 2, 400, 333
    feats = _bf16(gen, (b, c_in, f_in), cuda)
    kmap = torch.from_numpy(_sparse_kmap(gen, b, 27, c_in, c_out, 300, 0.3)).to(cuda)
    kernel = torch.from_numpy((gen.standard_normal((27, f_in, f_out)) / np.sqrt(f_in))
                              .astype(np.float32)).to(cuda)
    before = kernels.launch_counts()["gather_conv_bf16"]
    got = kernels.gather_conv(feats, kmap, kernel)
    assert kernels.launch_counts()["gather_conv_bf16"] == before + len(
        kernels.width_plan(f_in, f_out, bf16=True).out_chunks)
    _one_bf16_ulp(got, kernels.gather_conv_plain(feats, kmap, kernel))
    assert torch.equal(kernels.gather_conv(feats, kmap, kernel), got)


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(_BODIES))
@pytest.mark.parametrize("n_groups", [2, 4])
def test_gather_conv_bf16_cuda_body_offset_groups(cuda, monkeypatch, body, n_groups):
    """Each body with its offsets split over 2 and 4 blocks (the f32 partial
    sums added in order by the second launch), K = 27 and 125 (more
    offsets than one group of 32): within one ulp, bit-equal on repeat."""
    _force_body(monkeypatch, body)
    monkeypatch.setattr(kernels, "offset_groups", lambda *a: n_groups)
    gen = np.random.default_rng(n_groups)
    for k_vol in (27, 125):
        b, c_in, c_out, f = 3, 600, 500, 64
        feats = _bf16(gen, (b, c_in, f), cuda)
        kmap = torch.from_numpy(_sparse_kmap(gen, b, k_vol, c_in, c_out, 400, 0.2)).to(cuda)
        kernel = torch.from_numpy((gen.standard_normal((k_vol, f, f)) / np.sqrt(f))
                                  .astype(np.float32)).to(cuda)
        epi = _epi(gen, f, b, c_out, cuda)
        got = kernels.gather_conv(feats, kmap, kernel, epi=epi)
        _one_bf16_ulp(got, kernels.gather_conv_plain(feats, kmap, kernel, epi=epi))
        assert torch.equal(kernels.gather_conv(feats, kmap, kernel, epi=epi), got)


def _dw_runs_kmap(gen, b, k_vol, c_in, c_out, n_run):
    """Every 64-row tile valid at exactly n_run rows an offset, but every
    third tile empty: a chunk's queue of valid rows fills stages of 64 across
    tiles and ends mid-tile."""
    kmap = np.full((b, k_vol, c_out), c_in, np.int64)
    for bi in range(b):
        for k in range(k_vol):
            for t0 in range(0, c_out, 64):
                if (t0 // 64) % 3 == 2:
                    continue
                n = min(n_run, c_out - t0)
                rows = t0 + gen.choice(min(64, c_out - t0), size=n, replace=False)
                kmap[bi, k, rows] = gen.integers(0, c_in, n)
    return kmap.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(_BODIES))
@pytest.mark.parametrize("n_run", [1, 8, 63, 64])
@pytest.mark.parametrize("k_vol,f_in,f_out", [(27, 32, 32), (8, 64, 128), (27, 128, 64),
                                              (8, 512, 512)])
def test_gather_dw_bf16_cuda_stage_runs(cuda, monkeypatch, body, n_run, k_vol, f_in, f_out):
    """Tiles of exactly n_run valid rows an offset and empty tiles between
    them, so the SM90 body's queue fills its 64-row stages across tiles,
    splits tiles between stages and ends each chunk mid-tile (a last stage
    of n < 64 rows); widths 32-512: within 1e-4 x max |plain|, bit-equal on
    repeat."""
    _force_body(monkeypatch, body)
    gen = np.random.default_rng(n_run * 7 + k_vol + f_in)
    b, c_in, c_out = 3, 700, 1000
    feats = _bf16(gen, (b, c_in, f_in), cuda)
    kmap = torch.from_numpy(_dw_runs_kmap(gen, b, k_vol, c_in, c_out, n_run)).to(cuda)
    g = _bf16(gen, (b, c_out, f_out), cuda)
    got = kernels.gather_dw(feats, kmap, g)
    assert _rel_err(got, kernels.gather_dw_plain(feats, kmap, g)) <= DW_REL_TOL
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(_BODIES))
@pytest.mark.parametrize("chunks", [1, 7, 64])
def test_gather_dw_bf16_cuda_chunk_counts(cuda, monkeypatch, body, chunks):
    """One chunk walking every tile (many stages), an odd count, and more
    chunks than the tiles a few of them reach (chunks without a tile write
    zeros): within 1e-4 x max |plain|, bit-equal on repeat."""
    _force_body(monkeypatch, body)
    monkeypatch.setattr(kernels, "dw_tiling",
                        lambda b, c_out, f_in, f_out, k_vol, body=0: (64, 64, chunks))
    gen = np.random.default_rng(chunks)
    b, c_in, c_out, f = 2, 900, 1500, 64
    feats, kmap, g = _dw_bf16_case(gen, b, c_in, c_out, 27, f, f, cuda)
    got = kernels.gather_dw(feats, kmap, g)
    assert _rel_err(got, kernels.gather_dw_plain(feats, kmap, g)) <= DW_REL_TOL
    assert torch.equal(kernels.gather_dw(feats, kmap, g), got)


# bf16 call shapes (B, C_out, F_in, F_out, K) of the EgoNN forward and train
# step and of wider convs
_BF16_SHAPES = [(32, 9856, 32, 32, 27), (32, 9856, 32, 32, 8), (32, 6656, 32, 64, 27),
                (32, 6656, 64, 64, 27), (32, 2560, 128, 128, 27), (32, 1664, 128, 128, 8),
                (32, 1408, 128, 128, 27), (8, 1024, 128, 128, 27), (8, 9856, 32, 32, 27),
                (8, 4096, 64, 32, 8), (4, 4096, 256, 512, 27), (32, 1665, 128, 128, 27),
                (8, 20480, 32, 32, 27), (8, 10240, 32, 64, 27)]


@pytest.mark.parametrize("b,c_out,f_in,f_out,k_vol", _BF16_SHAPES)
def test_bf16_body_rules(b, c_out, f_in, f_out, k_vol):
    """The bf16 bodies' launch rules against a plain statement of them: the
    SM90 conv on the deep levels (C_out <= 1664) and the 32-wide K >= 27
    self convs, with 64-column slices where F_out allows; offsets split
    only on grids of at most two blocks an SM (SM90) or 512 blocks (SM80 on
    bf16 features; f32 features keep their rule); the SM90 dW but
    for 32-wide features at K >= 27, its chunks one wave of three blocks an
    SM; the SM80 rules (slices, offset groups, chunks) unchanged."""
    sm90_conv = c_out <= 1664 or (f_in == 32 and f_out == 32 and k_vol >= 27)
    assert kernels.conv_body(b, c_out, f_in, f_out, k_vol) == (
        kernels.SM90 if sm90_conv else kernels.SM80)
    assert kernels.conv_cols(b, c_out, f_out, k_vol, kernels.SM90) == (
        64 if f_out % 64 == 0 else 32)
    assert kernels.conv_cols(b, c_out, f_out, k_vol, kernels.SM80) == kernels.conv_cols(
        b, c_out, f_out, k_vol)
    assert kernels.dw_body(b, c_out, f_in, f_out, k_vol) == (
        kernels.SM80 if f_in <= 32 and k_vol >= 27 else kernels.SM90)
    mb, nb, chunks = kernels.dw_tiling(b, c_out, f_in, f_out, k_vol, kernels.SM90)
    blocks = k_vol * (f_in // mb) * (f_out // nb)
    for body, limit in ((kernels.SM90, 2 * 132), (kernels.SM80, 512)):
        groups = kernels.offset_groups(b, c_out, f_in, f_out, k_vol, body, True)
        cols = kernels.conv_cols(b, c_out, f_out, k_vol, body)
        assert 1 <= groups <= min(4, k_vol)
        assert groups == 1 or b * -(-c_out // 128) * (f_out // cols) <= limit
    assert kernels.offset_groups(b, c_out, f_in, f_out, k_vol) == kernels.offset_groups(
        b, c_out, f_in, f_out, k_vol, kernels.SM80, False)
    assert (mb, nb) == kernels.dw_tiling(b, c_out, f_in, f_out, k_vol)[:2]
    assert chunks == max(1, min(b * -(-c_out // 64), 3 * 132 // blocks))
    assert chunks * blocks <= 3 * 132 or chunks == 1


def test_probe_cut_libraries_apart():
    """The bf16 bodies' cut-outs are built only into libraries of their own
    (EGONN_PROBE_CUTS), never into the port's, and each cut-out entry point
    takes its production entry's arguments plus the cut-out (and, for the
    conv, the room for the SM80 body's lists)."""
    for src, extra in cuda_lib.PROBE_SIGNATURES.items():
        probe = cuda_lib._library_path(src, cuda_lib.PROBE_FLAGS)
        assert probe != cuda_lib._library_path(src) and "-probe-" in probe.name
        for name, argtypes in extra.items():
            base = cuda_lib.SIGNATURES[src][name.removesuffix("_cut")]
            assert argtypes[:len(base) - 1] == base[:-1] and argtypes[-1] == base[-1]
            assert len(argtypes) == len(base) + (2 if src == "gather_conv.cu" else 1)


def test_bf16_body_counts_reset():
    """The per-body launch counts start at zero after reset_launches, and CPU
    calls (the plain versions) count nothing."""
    kernels.reset_launches()
    gen = np.random.default_rng(3)
    feats = torch.from_numpy(gen.standard_normal((1, 50, 32)).astype(np.float32)).to(
        torch.bfloat16)
    kmap = torch.from_numpy(gen.integers(0, 51, (1, 27, 40)).astype(np.int32))
    kernels.gather_conv(feats, kmap, torch.zeros(27, 32, 32))
    kernels.gather_dw(feats, kmap, torch.zeros(1, 40, 32, dtype=torch.bfloat16))
    assert kernels.body_launch_counts() == {name: {"sm80": 0, "sm90": 0}
                                            for name in ("gather_conv_bf16", "gather_dw_bf16")}
