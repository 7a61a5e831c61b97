"""The port's kernel wrappers (egonn_tpu_torch.sparse.kernels) on random data.

CPU cases check the plain versions against brute force and the dispatch
rules.  Cases marked `cuda` hold each CUDA kernel against its plain version
on odd shapes and edge cases (ragged tiles, all-sentinel maps, every width)
and check that bad inputs raise; they skip without a card.  This module
imports no JAX, so on a machine with only torch they run with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse.packing import MAXKEY

REL_TOL = 1e-5  # f32 FMA kernels against f32 torch matmuls: summation order only


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


def test_cpu_calls_count_no_launches():
    kernels.reset_launches()
    feats = torch.randn(1, 10, 4)
    kmap = torch.randint(0, 11, (1, 27, 10), dtype=torch.int32)
    kernels.gather_conv(feats, kmap, torch.randn(27, 4, 32))
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_other_devices_raise():
    meta = torch.empty(1, 10, 4, device="meta")
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        kernels.gather_conv(meta, torch.zeros(1, 27, 10, dtype=torch.int32),
                            torch.zeros(27, 4, 32))


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


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", [(32, 32), (128, 128)])
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


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_inputs(cuda):
    feats = torch.zeros(1, 64, 32, device=cuda)
    kmap = torch.zeros(1, 27, 64, dtype=torch.int32, device=cuda)
    kernel = torch.zeros(27, 32, 32, device=cuda)
    with pytest.raises(TypeError):
        kernels.gather_conv(feats.double(), kmap, kernel.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gather_conv(feats.transpose(1, 2).contiguous().transpose(1, 2), kmap, kernel)
    with pytest.raises(ValueError, match="F_out"):
        kernels.gather_conv(feats, kmap, torch.zeros(27, 32, 48, device=cuda))
    with pytest.raises(ValueError, match="expected all on CUDA or all on the CPU"):
        kernels.gather_conv(feats, kmap.cpu(), kernel)
    with pytest.raises(ValueError, match="kz"):
        kernels.zrun_rank(torch.zeros(1, 8, dtype=torch.int32, device=cuda),
                          torch.zeros(1, 1, 8, dtype=torch.int32, device=cuda), 9)
