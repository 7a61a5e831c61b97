"""The stem over constant-ones features (`kernels.stem_ones` and
`sparse/conv.py::sparse_conv_ones` around it, whose dW is one torch.mm on
the 0/1 matrix rebuilt from the saved map).

CPU cases check the autograd Function's dW against brute force and against
autograd through the plain (JAX package's) form, bit for bit, that it saves
the map alone, and that CPU calls launch nothing.  Cases marked `cuda` hold
the kernel against its plain version at the level-0 shapes of EgoNN (C
16,384) and MinkLoc3D (C 40,960) with K 125 and F_out 32 and a few clouds
(with an empty cloud and padded columns), on ragged and other widths, check
that repeats are bit-equal, that the Function's dW on the card is autograd's
through the plain form bit for bit, and that unsupported shapes raise; they
skip without a card.  This module imports no JAX, so on a machine with only
torch they run with

    python -m pytest tests/test_torch_stem.py -m cuda --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu_torch.sparse import conv as sconv
from egonn_tpu_torch.sparse import kernels

# the forward sums the same rows in the same order as a GEMM without
# split-K: within f32 rounding of the plain version's product
REL_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stem_inputs(seed, b, c, k_vol=125, f_out=32, n_valid=None, density=0.15):
    """A self map (B, K, C) int32 whose valid entries are indices below C and
    whose absent ones are the sentinel C (some past it); columns from
    n_valid on are padding (every entry the sentinel), cloud 0 empty when
    b > 1; the kernel (K, 1, F_out) and a cotangent (B, C, F_out)."""
    gen = np.random.default_rng(seed)
    n_valid = c if n_valid is None else n_valid
    valid = gen.random((b, k_vol, c)) < density
    valid[:, k_vol // 2, :] = True  # the centre offset: the voxel itself
    valid[:, :, n_valid:] = False
    if b > 1:
        valid[0] = False
    kmap = np.where(valid, gen.integers(0, c, (b, k_vol, c)), c)
    kmap = np.where(~valid & (gen.random((b, k_vol, c)) < 0.05), c + 7, kmap)
    kernel = gen.standard_normal((k_vol, 1, f_out)) * np.sqrt(2.0 / (k_vol * f_out))
    g = gen.standard_normal((b, c, f_out))
    return (torch.from_numpy(kmap.astype(np.int32)), torch.from_numpy(kernel.astype(np.float32)),
            torch.from_numpy(g.astype(np.float32)))


def _plain_form(kmap, kernel, n_in_rows, dtype=torch.float32):
    """The stem as one torch product on the 0/1 matrix, as autograd sees it."""
    valid = (kmap < n_in_rows).to(kernel.dtype)
    return torch.matmul(valid.transpose(1, 2), kernel[:, 0, :]).to(dtype)


def _grads(kmap, kernel, g, n_in_rows, dtype=torch.float32):
    """(out, dW) through sparse_conv_ones and through the plain form."""
    got = []
    for fn in (sconv.sparse_conv_ones, _plain_form):
        w = kernel.clone().requires_grad_(True)
        out = fn(kmap, w, n_in_rows, dtype)
        (d,) = torch.autograd.grad(out, w, g.to(dtype))
        got.append((out.detach(), d))
    return got


def test_sparse_conv_ones_dw_matches_brute_force():
    kmap, kernel, g = _stem_inputs(0, 2, 40, k_vol=9, f_out=4)
    want = np.zeros((9, 1, 4))
    km, gn = kmap.numpy(), g.numpy().astype(np.float64)
    for i, k, c in np.ndindex(*km.shape):
        if km[i, k, c] < 40:
            want[k, 0] += gn[i, c]
    (_, got), _ = _grads(kmap, kernel, g, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_ones_function_matches_autograd_of_the_plain_form(dtype):
    """On the CPU the Function's forward is the plain form bit for bit and
    its dW is autograd's through the plain form bit for bit (the same
    torch.mm); no call is counted as a launch."""
    kernels.reset_launches()
    kmap, kernel, g = _stem_inputs(1, 3, 200, k_vol=27, f_out=8, n_valid=170)
    (out, d1), (want, d2) = _grads(kmap, kernel, g, 200, dtype)
    assert out.dtype == dtype and torch.equal(out, want)
    assert d1.shape == d2.shape == kernel.shape and d1.dtype == torch.float32
    assert torch.equal(d1, d2)
    assert kernels.launch_counts()["stem_ones"] == 0


def test_sparse_conv_ones_saves_only_the_map():
    """The backward keeps the int32 map, not the 0/1 f32 matrix; a kernel
    that needs no gradient builds no graph."""
    kmap, kernel, _ = _stem_inputs(2, 2, 64, k_vol=27, f_out=8)
    w = kernel.clone().requires_grad_(True)
    node = sconv.sparse_conv_ones(kmap, w, 64).grad_fn
    (saved,) = node.saved_tensors
    assert saved.dtype == torch.int32 and torch.equal(saved, kmap)
    assert sconv.sparse_conv_ones(kmap, kernel, 64).grad_fn is None


def _to(device, *ts):
    return [t.to(device) for t in ts]


def _assert_close(got, want, rel):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n_valid", [(3, 16384, 11000), (2, 40960, 29000)])
def test_stem_ones_cuda_at_level0_shapes(cuda, b, c, n_valid):
    """EgoNN's and MinkLoc3D's level-0 maps (K 125, F_out 32) with an empty
    cloud and padded columns: within REL_TOL of the plain version; repeats
    bit-equal; one launch a call."""
    kmap, kernel, _ = _to(cuda, *_stem_inputs(2, b, c, n_valid=n_valid))
    before = kernels.launch_counts()["stem_ones"]
    got = kernels.stem_ones(kmap, kernel, c)
    assert kernels.launch_counts()["stem_ones"] == before + 1
    want = kernels.stem_ones_plain(kmap, kernel, c)
    assert got.dtype == torch.float32 and got.shape == (b, c, 32)
    _assert_close(got, want, REL_TOL)
    assert not bool(got[0].any()) and not bool(got[:, n_valid:].any())
    assert torch.equal(kernels.stem_ones(kmap, kernel, c), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,k_vol,f_out", [(2, 1000, 125, 32), (1, 77, 27, 4), (2, 300, 343, 48),
                                             (3, 513, 125, 64), (2, 4096, 1, 36)])
def test_stem_ones_cuda_ragged_and_other_widths(cuda, b, c, k_vol, f_out):
    """Columns that fill no whole block or warp, F_out in several 32-wide
    slices or below 32, K from 1 to 343."""
    kmap, kernel, _ = _to(cuda, *_stem_inputs(3, b, c, k_vol, f_out, n_valid=c - 5))
    _assert_close(kernels.stem_ones(kmap, kernel, c), kernels.stem_ones_plain(kmap, kernel, c),
                  REL_TOL)


@pytest.mark.cuda
def test_stem_cuda_unaligned_map(cuda):
    """A map whose rows are not 16-byte aligned (a view 4 bytes into its
    storage): the same sums."""
    kmap, kernel, _ = _to(cuda, *_stem_inputs(8, 2, 4096, n_valid=4000))
    store = torch.empty(kmap.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = store[1:].view(kmap.shape)
    shifted.copy_(kmap)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert torch.equal(kernels.stem_ones(shifted, kernel, 4096),
                       kernels.stem_ones(kmap, kernel, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_ones_cuda_backward(cuda, dtype):
    """Through the autograd Function on the card, at EgoNN's level-0 shape:
    the forward launches the kernel once and is within REL_TOL of the plain
    form; dW is autograd's through the plain form bit for bit."""
    kmap, kernel, g = _to(cuda, *_stem_inputs(6, 2, 16384, n_valid=12000))
    before = kernels.launch_counts()["stem_ones"]
    (out, d1), (want, d2) = _grads(kmap, kernel, g, 16384, dtype)
    assert kernels.launch_counts()["stem_ones"] == before + 1
    assert out.dtype == dtype
    _assert_close(out, want, REL_TOL if dtype == torch.float32 else 1e-2)
    assert torch.equal(d1, d2)


@pytest.mark.cuda
def test_stem_cuda_raises_on_bad_inputs(cuda):
    kmap, kernel, _ = _to(cuda, *_stem_inputs(7, 1, 64, k_vol=27, f_out=32))
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.stem_ones(kmap, kernel[..., :30].contiguous(), 64)
    big = torch.full((1, 344, 64), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="K <= 343"):
        kernels.stem_ones(big, torch.zeros(344, 1, 32, device=cuda), 64)
    with pytest.raises(TypeError):
        kernels.stem_ones(kmap, kernel.double(), 64)
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        kernels.stem_ones(kmap.cpu(), kernel, 64)
