"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU: it carries the `cuda` marker and skips
with a reason where there is none (CUDA kernels have no CPU mode). This file
imports no jax, so it also runs on a GPU host without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

It also holds the input makers that tests/test_torch_kernels.py shares.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_torch.kernels import launch_counts
from hashnerf_torch.kernels import hash_encode as he
from hashnerf_torch.kernels.segment_accum import (
    K4_MIN_F, segment_accumulate_k4, segment_accumulate_k5_plain, segment_accumulate_sorted,
    segment_accumulate_sorted_plain, sort_segments, sorted_segment_accumulate,
)
from hashnerf_torch.ops.hash_encoding import HashGridConfig, encode_with_resolutions

K1_CASES = ["dense", "single_hot_row", "sparse", "large_m_same_sign", "wide_f8"]


def k1_case(name):
    """The five cases of tests/test_kernels.py: (idx, vals, num_rows)."""
    rng = np.random.default_rng(0)
    if name == "dense":
        return rng.integers(0, 2048, 5000).astype(np.int32), rng.normal(size=(5000, 2)).astype(np.float32), 2048
    if name == "single_hot_row":
        return np.full(100, 2500, np.int32), np.ones((100, 2), np.float32), 4096
    if name == "sparse":
        return rng.integers(0, 1 << 16, 3000).astype(np.int32), rng.normal(size=(3000, 2)).astype(np.float32), 1 << 16
    if name == "large_m_same_sign":
        return (rng.integers(0, 1024, 200_000).astype(np.int32),
                rng.uniform(0.5, 1.5, size=(200_000, 1)).astype(np.float32), 1024)
    if name == "wide_f8":
        return rng.integers(0, 2048, 4000).astype(np.int32), rng.normal(size=(4000, 8)).astype(np.float32), 2048
    raise KeyError(name)


SCATTER_FAMILIES = ["dense_f2", "single_hot_row", "sparse", "f8", "f64", "f216"]


def scatter_family(name):
    """Scatter-add inputs (idx, vals, num_rows) at the callers' row widths:
    the chair table (F = 2, int32 ids from K3), the packed TV cubes (F = 8),
    the packed voxel rows (64) and fine slabs (216), these with the int64
    ids that take_rows passes."""
    if name in ("single_hot_row", "sparse"):
        return k1_case(name)
    if name == "dense_f2":
        return k1_case("dense")
    if name == "f8":
        return k1_case("wide_f8")
    F = int(name[1:])
    rng = np.random.default_rng(F)
    return (rng.integers(0, 4096, 3000).astype(np.int64),
            rng.normal(size=(3000, F)).astype(np.float32), 4096)


def encode_inputs(seed, L, log2_T, base, finest, n, lo, hi):
    """(table, x, probe, bmin, bmax, cfg): a normal table, points in the bbox
    grown by 20% on each side, a normal cotangent for the features."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(L, 1 << log2_T, 2)).astype(np.float32)
    x = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3)).astype(np.float32)
    probe = rng.normal(size=(n, 2 * L)).astype(np.float32)
    bmin = np.full(3, lo, np.float32)
    bmax = np.full(3, hi, np.float32)
    cfg = HashGridConfig(n_levels=L, log2_hashmap_size=log2_T, base_resolution=base,
                         finest_resolution=finest)
    return table, x, probe, bmin, bmax, cfg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_on_card_matches_plain(cuda_device, case):
    idx, vals, T = k1_case(case)
    i = torch.from_numpy(idx).to(cuda_device)
    v = torch.from_numpy(vals).to(cuda_device)
    si, sv = sort_segments(i, v)
    before = launch_counts()["segment_accumulate_k1"]
    got = segment_accumulate_sorted(si, sv, T)
    assert launch_counts()["segment_accumulate_k1"] == before + 1
    # float32 sums of the same terms in another order
    torch.testing.assert_close(got, segment_accumulate_sorted_plain(si, sv, T), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_hash_encode_on_card_matches_plain(cuda_device):
    table, x, probe, bmin, bmax, cfg = encode_inputs(3, 16, 14, 16, 512, 4096, -1.6, 1.6)
    dev = cuda_device
    res = cfg.resolutions_tensor(dev)
    args = [torch.from_numpy(a).to(dev) for a in (x, bmin, bmax)] + [res]
    g = torch.from_numpy(probe).to(dev)
    before = launch_counts()

    tt = torch.from_numpy(table).to(dev).requires_grad_(True)
    f, k = he.hash_encode(tt, *args)
    (f * g).sum().backward()
    after = launch_counts()
    path = ("hash_encode_fwd", "hash_encode_bwd_expand", "segment_accumulate_k5")
    assert all(after[n] == before[n] + (n in path) for n in after)

    fp, kp = he.hash_encode_fwd_plain(tt.detach(), *args)
    assert torch.equal(k, kp)
    # same corners and weights; the blend may sum in another order
    torch.testing.assert_close(f.detach(), fp, rtol=1e-5, atol=1e-7)
    tp = torch.from_numpy(table).to(dev).requires_grad_(True)
    fq, _ = encode_with_resolutions(tp, *args, 14)
    (fq * g).sum().backward()
    torch.testing.assert_close(tt.grad, tp.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fine_slabs", "hot_row", "large_m_same_sign"])
def test_k4_at_f216_on_card_matches_plain(cuda_device, case):
    """K4 at the packed fine slab's width, 27 * 8 = 216 floats."""
    F, T = 216, 1 << 14
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if case == "fine_slabs":
        idx = torch.randint(0, T, (50_000,), generator=gen, device=cuda_device, dtype=torch.int32)
        vals = torch.randn((50_000, F), generator=gen, device=cuda_device)
    elif case == "hot_row":
        idx = torch.full((20_000,), 77, dtype=torch.int32, device=cuda_device)
        vals = torch.ones((20_000, F), device=cuda_device)
    else:
        idx = torch.randint(0, 512, (100_000,), generator=gen, device=cuda_device, dtype=torch.int32)
        vals = torch.rand((100_000, F), generator=gen, device=cuda_device) + 0.5
    assert F >= K4_MIN_F
    sidx, svals = sort_segments(idx, vals)
    before = launch_counts()["segment_accumulate_k4"]
    got = segment_accumulate_sorted(sidx, svals, T)
    assert launch_counts()["segment_accumulate_k4"] == before + 1
    if case == "hot_row":
        assert bool((got[77] == 20_000).all()) and float(got.abs().sum()) == 20_000 * F
    elif case == "large_m_same_sign":
        # float64 oracle at rtol 2e-5: same-sign values must not lose small rows
        oracle = torch.zeros((T, F), dtype=torch.float64, device=cuda_device).index_add_(
            0, idx.long(), vals.double())
        torch.testing.assert_close(got.double(), oracle, rtol=2e-5, atol=0.0)
    else:
        # float32 sums of the same terms in another order
        torch.testing.assert_close(got, segment_accumulate_sorted_plain(sidx, svals, T),
                                   rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(segment_accumulate_k4(sidx, svals, T), got, rtol=1e-4, atol=1e-5)


def within_row_abs_sum(got, plain, idx, vals, T):
    """Atomics add in an order that changes from run to run: each entry may
    differ from the plain version by 2e-5 of its row's absolute sum."""
    abs_sum = segment_accumulate_k5_plain(idx, vals.abs(), T)
    return bool(((got - plain).abs() <= 2e-5 * abs_sum + 1e-6).all())


def k5_inputs(dev, case):
    """K5's card cases: those of tests/test_kernels.py and the F = 216 ones."""
    if case in K1_CASES:
        idx, vals, T = k1_case(case)
        return torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev), T
    F, T = 216, 1 << 14
    gen = torch.Generator(device=dev).manual_seed(0)
    if case == "f216_slabs":
        return (torch.randint(0, T, (50_000,), generator=gen, device=dev),
                torch.randn((50_000, F), generator=gen, device=dev), T)
    if case == "f216_hot_row":
        return torch.full((20_000,), 77, dtype=torch.int64, device=dev), torch.ones((20_000, F), device=dev), T
    return (torch.randint(0, 512, (100_000,), generator=gen, device=dev),
            torch.rand((100_000, F), generator=gen, device=dev) + 0.5, T)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["shuffled", "sorted"])
@pytest.mark.parametrize("case", K1_CASES + ["f216_slabs", "f216_hot_row", "f216_same_sign"])
def test_k5_on_card_matches_plain(cuda_device, case, order):
    idx, vals, T = k5_inputs(cuda_device, case)
    if order == "sorted":
        idx, vals = sort_segments(idx, vals)
    before = launch_counts()
    got = sorted_segment_accumulate(idx, vals, T)
    after = launch_counts()
    # the router launches K5 and nothing else: no sort + K1/K4
    assert all(after[n] == before[n] + (n == "segment_accumulate_k5") for n in after)
    if case in ("single_hot_row", "f216_hot_row"):
        row, m = (2500, 100) if case == "single_hot_row" else (77, 20_000)
        assert bool((got[row] == m).all()) and float(got.abs().sum()) == m * vals.shape[1]
    elif case in ("large_m_same_sign", "f216_same_sign"):
        # float64 oracle at rtol 2e-5: same-sign values must not lose small rows
        oracle = torch.zeros(got.shape, dtype=torch.float64, device=cuda_device).index_add_(
            0, idx.long(), vals.double())
        torch.testing.assert_close(got.double(), oracle, rtol=2e-5, atol=0.0)
    else:
        plain = segment_accumulate_k5_plain(idx, vals, T)
        assert within_row_abs_sum(got, plain, idx, vals, T)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [2, 216])
def test_k5_drops_out_of_range_ids(cuda_device, F):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    T = 1000
    idx = torch.randint(-50, T + 50, (30_000,), generator=gen, device=cuda_device)
    idx[::97] = 2**31 - 1  # far outside the table, in int32's range too
    idx[1::97] = -(2**31)
    vals = torch.randn((30_000, F), generator=gen, device=cuda_device)
    for ids in (idx, idx.int()):
        got = sorted_segment_accumulate(ids, vals, T)
        torch.cuda.synchronize()  # a write out of bounds would fault here
        ok = (idx >= 0) & (idx < T)
        plain = segment_accumulate_k5_plain(idx[ok], vals[ok], T)
        assert within_row_abs_sum(got, plain, idx[ok], vals[ok], T)

