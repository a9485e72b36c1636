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
    K4_MIN_F, segment_accumulate_k4, segment_accumulate_k5, segment_accumulate_k5_plain,
    segment_accumulate_sorted,
    segment_accumulate_sorted_plain, sort_segments, sorted_segment_accumulate,
)
from hashnerf_torch.kernels import packed_encode as pe
from hashnerf_torch.kernels.packed_encode import table_shapes
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


def encode_inputs(seed, L, log2_T, base, finest, n, lo, hi, F=2):
    """(table, x, probe, bmin, bmax, cfg): a normal table, points in the bbox
    grown by 20% on each side, a normal cotangent for the features."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(L, 1 << log2_T, F)).astype(np.float32)
    x = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3)).astype(np.float32)
    probe = rng.normal(size=(n, F * L)).astype(np.float32)
    bmin = np.full(3, lo, np.float32)
    bmax = np.full(3, hi, np.float32)
    cfg = HashGridConfig(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_T,
                         base_resolution=base, finest_resolution=finest)
    return table, x, probe, bmin, bmax, cfg


def snap_to_vertices(x, cfg, lo, hi, frac, seed):
    """x with a fraction `frac` of its points moved onto grid vertices of a
    random level, computed in float32 as the encoder computes them, so that
    floor() meets cell boundaries."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    res = np.asarray(cfg.resolutions, np.float32)[rng.integers(0, cfg.n_levels, n)]
    grid = (np.float32(hi) - np.float32(lo)) / res
    k = np.floor(rng.uniform(0, 1, (n, 3)) * res[:, None]).astype(np.float32)
    snapped = (k * grid[:, None] + np.float32(lo)).astype(np.float32)
    pick = rng.random(n) < frac
    out = x.copy()
    out[pick] = snapped[pick]
    return out


# Packed-layout (K7 / K8) configs and point families, shared with
# tests/test_torch_packed_kernels.py: L4 has one dense level and three
# block-hashed ones, L8 three and five.
PACKED_CONFIGS = {
    "L4_F1": dict(n_levels=4, n_features_per_level=1, log2_hashmap_size=13, finest_resolution=32),
    "L4_F2": dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13, finest_resolution=32),
    "L4_F4": dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=13, finest_resolution=32),
    "L4_F8": dict(n_levels=4, n_features_per_level=8, log2_hashmap_size=13, finest_resolution=32),
    "L8_F4": dict(n_levels=8, n_features_per_level=4, log2_hashmap_size=15, finest_resolution=128),
    "no_dense": dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=12, finest_resolution=32),
    "no_fine": dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=16, finest_resolution=32),
}
LEVEL_KINDS = {"L4_F1": (1, 3), "L4_F2": (1, 3), "L4_F4": (1, 3), "L4_F8": (1, 3), "L8_F4": (3, 5),
               "no_dense": (0, 4), "no_fine": (4, 0)}
PACKED_FAMILIES = ["vertices", "faces", "outside", "block_edges"]


def packed_config(name, mod=None):
    """PACKED_CONFIGS[name] as a PackedGridConfig of `mod` (the port's
    ops/packed_grid.py by default; the JAX package's in the CPU tests)."""
    from hashnerf_torch.ops import packed_grid

    return (mod or packed_grid).PackedGridConfig(**PACKED_CONFIGS[name], base_resolution=16,
                                                  log2_blocks=10)


def packed_tables(cfg, seed):
    """Normal tables (not the 1e-4 init, so that the sums are not tiny), only
    those the config has."""
    rng = np.random.default_rng(seed)
    dense, fine = table_shapes(cfg)
    out = {}
    if dense:
        out["dense"] = rng.normal(size=dense).astype(np.float32)
    if fine:
        out["fine"] = rng.normal(size=fine).astype(np.float32)
    return out


def packed_points(cfg, family, n, seed, lo=-1.5, hi=1.5):
    """n points of a family, in float32 (vertices computed as the encoder
    computes a cell: k * ((hi - lo) / res) + lo) in the bbox [lo, hi]^3."""
    rng = np.random.default_rng(seed)
    ext = np.float32(hi - lo)
    res = np.asarray(cfg.resolutions, np.float32)[rng.integers(0, cfg.n_levels, n)][:, None]
    grid = ext / res
    if family == "vertices":  # every vertex of a random level, the top face's too
        k = np.floor(rng.uniform(0, 1, (n, 3)) * (res + 1)).astype(np.float32)
        return (k * grid + np.float32(lo)).astype(np.float32)
    if family == "faces":  # one or more coordinates on a face of the bbox
        x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        on = rng.random((n, 3)) < 0.5
        on[np.arange(n), rng.integers(0, 3, n)] = True
        x[on] = np.where(rng.random(on.sum()) < 0.5, np.float32(lo), np.float32(hi))
        return x
    if family == "outside":  # the bbox grown by 20% on each side: most points outside
        return rng.uniform(lo - 0.2 * ext, hi + 0.2 * ext, (n, 3)).astype(np.float32)
    if family == "block_edges":  # even vertices (macro-block faces) and one float either side
        k = 2 * np.floor(rng.uniform(0, 1, (n, 3)) * (res // 2 + 1)).astype(np.float32)
        x = (k * grid + np.float32(lo)).astype(np.float32)
        step = rng.integers(-1, 2, (n, 3))
        return np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                        np.where(step > 0, np.nextafter(x, np.float32(np.inf)), x)).astype(np.float32)
    raise KeyError(family)


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
    path = ("hash_encode_fwd", "hash_encode_bwd")
    assert all(after[n] == before[n] + (n in path) for n in after)

    fp, kp = he.hash_encode_fwd_plain(tt.detach(), *args)
    assert torch.equal(k, kp)
    # same corners and weights; the blend may sum in another order
    torch.testing.assert_close(f.detach(), fp, rtol=1e-5, atol=1e-7)
    tp = torch.from_numpy(table).to(dev).requires_grad_(True)
    fq, _ = encode_with_resolutions(tp, *args, 14)
    (fq * g).sum().backward()
    torch.testing.assert_close(tt.grad, tp.grad, rtol=1e-4, atol=1e-5)


def layout_inputs(dev, F):
    """K2 / K6 inputs with N = 4001 (not a multiple of 32: a warp tail), a
    third of the points outside the bbox and a tenth on grid vertices."""
    table, x, probe, bmin, bmax, cfg = encode_inputs(5, 16, 12, 16, 512, 4001, -1.6, 1.6, F=F)
    x = snap_to_vertices(x, cfg, -1.6, 1.6, 0.1, seed=6)
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(table), [to(x), to(bmin), to(bmax), cfg.resolutions_tensor(dev)], to(probe)


@pytest.mark.cuda
@pytest.mark.parametrize("group_levels", [1, 4, 16])
@pytest.mark.parametrize("F", [1, 2, 3, 8])
def test_k6_on_card_matches_plain(cuda_device, monkeypatch, F, group_levels):
    monkeypatch.setattr(he, "_K6_GROUP_LEVELS", group_levels)
    table, args, g = layout_inputs(cuda_device, F)
    T = table.shape[1]
    before = launch_counts()
    got = he.hash_encode_bwd(*args, g, T)
    after = launch_counts()
    assert all(after[n] == before[n] + (n == "hash_encode_bwd") for n in after)
    torch.cuda.synchronize()
    plain = he.hash_encode_bwd_plain(*args, g, T)
    # atomics add in an order that changes from run to run: each entry may
    # differ from the plain version by 2e-5 of its row's absolute sum
    abs_sum = he.hash_encode_bwd_plain(*args, g.abs(), T)
    assert got.shape == plain.shape == table.shape
    assert bool(((got - plain).abs() <= 2e-5 * abs_sum + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("group_levels", [1, 4, 16])
@pytest.mark.parametrize("F", [1, 2, 3, 8])
def test_k2_layouts_on_card_match_plain(cuda_device, monkeypatch, F, group_levels):
    monkeypatch.setattr(he, "_K2_GROUP_LEVELS", group_levels)
    table, args, _ = layout_inputs(cuda_device, F)
    before = launch_counts()["hash_encode_fwd"]
    f, k = he.hash_encode_fwd(table, *args)
    assert launch_counts()["hash_encode_fwd"] == before + 1
    fp, kp = he.hash_encode_fwd_plain(table, *args)
    assert torch.equal(k, kp)
    # same corners and weights; the blend may round its products differently
    torch.testing.assert_close(f, fp, rtol=1e-5, atol=1e-7)


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


def packed_tv_cases(dev):
    """{name: (idx, vals, num_rows)}: the TV losses' own ids at the packed
    path's widths (chip_smoke.tv_rows: each dense level's cube, the slab
    rows), and 4,096 slab rows all on one row."""
    import chip_smoke

    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for name, ((T, F), idx) in chip_smoke.tv_rows(torch, dev).items():
        if name.startswith("packed"):
            out[name] = (idx, torch.randn((idx.numel(), F), generator=gen, device=dev), T)
    out["one_row_f216"] = (torch.full((4096,), 77, device=dev),
                           torch.randn((4096, 216), generator=gen, device=dev), 131_072)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_k5_at_packed_tv_shapes(cuda_device, id_dtype):
    """K5 at the packed TV shapes, where its wide kernel walks a shorter
    chunk so that 4,096 updates still fill the card: every row within the
    row gate of the plain version on the CPU, and bit-equal to it where the
    row takes at most two updates (+0 + a + b is +0 + b + a)."""
    for name, (idx, vals, T) in packed_tv_cases(cuda_device).items():
        idx = idx.to(id_dtype)
        got = segment_accumulate_k5(idx, vals, T).cpu()
        i, v = idx.cpu().long(), vals.cpu()
        plain = segment_accumulate_k5_plain(i, v, T)
        assert within_row_abs_sum(got, plain, i, v, T), name
        few = torch.bincount(i, minlength=T) <= 2
        assert torch.equal(got[few], plain[few]), name


@pytest.mark.cuda
def test_k5_under_graph_capture(cuda_device):
    """The fill and the launch, with no host synchronisation: a CUDA graph
    holds them, and each replay zeroes the table anew and adds."""
    idx, vals, T = packed_tv_cases(cuda_device)["packed_tv_slabs"]
    i, v = idx.cpu().long(), vals.cpu()
    plain = segment_accumulate_k5_plain(i, v, T)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        segment_accumulate_k5(idx, vals, T)  # warm up on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()["segment_accumulate_k5"]
    with torch.cuda.graph(graph):
        out = segment_accumulate_k5(idx, vals, T)
    assert launch_counts()["segment_accumulate_k5"] == before + 1
    for _ in range(3):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert within_row_abs_sum(out.cpu(), plain, i, v, T)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["both", "dense", "fine"])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 6, 7, 8])
def test_k7_ragged_points_and_one_kind_of_level(cuda_device, F, kind):
    """K7 against its plain version at N = 1, 31 and 33 (a block's tile cut
    short, a warp's tail), for levels of both kinds, dense only and fine
    only: keep bit-equal, each feature within PACKED_BLEND_RTOL of its
    blend's absolute sum."""
    from hashnerf_torch.ops.packed_grid import PackedGridConfig

    L, finest, log2_T = {"both": (4, 64, 16), "dense": (2, 32, 16), "fine": (4, 512, 12)}[kind]
    cfg = PackedGridConfig(n_levels=L, n_features_per_level=F, log2_hashmap_size=log2_T,
                           base_resolution=16, finest_resolution=finest, log2_blocks=10)
    assert (cfg.dense_level_count > 0) == (kind != "fine")
    assert (len(cfg.fine_resolutions) > 0) == (kind != "dense")
    tabs = packed_tables(cfg, F)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    dense = to(tabs["dense"] * 1e4) if "dense" in tabs else None
    fine = to(tabs["fine"] * 1e4) if "fine" in tabs else None
    bmin, bmax = to(np.full(3, -1.5, np.float32)), to(np.full(3, 1.5, np.float32))
    for n in (1, 31, 33):
        x = to(packed_points(cfg, "faces", n, n))
        feats, keep = pe.packed_encode_fwd(dense, fine, x, bmin, bmax, cfg)
        want, want_keep = pe.packed_encode_fwd_plain(dense, fine, x, bmin, bmax, cfg)
        abs_sum, _ = pe.packed_encode_fwd_plain(None if dense is None else dense.abs(),
                                                None if fine is None else fine.abs(),
                                                x, bmin, bmax, cfg)
        torch.cuda.synchronize()
        assert torch.equal(keep, want_keep)
        assert bool(((feats - want).abs() <= PACKED_BLEND_RTOL * abs_sum).all())



# --------------------------------------------------------------------------- #
# Occupancy culling: the card gives the CPU's results
# --------------------------------------------------------------------------- #

OCC_BBOX = np.array([[-1.5] * 3, [1.5] * 3], np.float32)


def occ_inputs(R=64, n_rays=256, S=48, seed=0):
    """(grid (R^3,), points (n_rays, S, 3)): a ball of cells from {0.5, 1,
    2} with a fifth at 0, zeros elsewhere (ties everywhere), and points
    along rays at sorted depths in [2, 6], a tenth snapped onto cell
    boundaries."""
    rng = np.random.default_rng(seed)
    c = (np.arange(R) + 0.5) / R * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    ball = (x**2 + y**2 + z**2 < 0.4).reshape(-1)
    vals = rng.choice(np.float32([0.5, 1.0, 2.0]), R**3)
    vals[rng.random(R**3) < 0.2] = 0.0
    grid = np.where(ball, vals, 0.0).astype(np.float32)
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-0.5, 0.5, (n_rays, 3)) - 4.0 * d
    t = np.sort(rng.uniform(2.0, 6.0, (n_rays, S)), axis=1)
    p = (o[:, None] + t[..., None] * d[:, None]).astype(np.float32)
    cell = np.float32(3.0) / np.float32(R)
    snapped = (np.round((p + 1.5) / cell) * cell - 1.5).astype(np.float32)
    pick = rng.random((n_rays, S)) < 0.1
    return grid, np.where(pick[..., None], snapped, p)


def _both(dev, *arrays):
    return [torch.from_numpy(a) for a in arrays], [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("mode", ["sort1", "sort2", "cumsum"])
def test_cull_points_on_card_matches_cpu(cuda_device, block, mode):
    from hashnerf_torch.render import occupancy as occ

    grid, pts = occ_inputs()
    cfg = occ.OccupancyConfig(resolution=64)
    cpu, card = _both(cuda_device, grid, pts.reshape(-1, 3), OCC_BBOX)
    results = []
    for g, p, b in (cpu, card):
        s = occ.occupancy_scores(g, p, b, cfg)
        results.append((occ.cell_index(p, b, 64), s) + occ.cull_points(
            s.reshape(-1, block).amax(-1), 1536 // block, mode=mode))
    for want, got in zip(*results):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cull_per_ray_on_card_matches_cpu(cuda_device):
    from hashnerf_torch.render import occupancy as occ

    grid, pts = occ_inputs(seed=1)
    cfg = occ.OccupancyConfig(resolution=64, score_stride=2)
    cpu, card = _both(cuda_device, grid, pts, OCC_BBOX)
    out = []
    for g, p, b in (cpu, card):
        s = occ.occupancy_scores_strided(occ.dilate_grid(g, 64), p, b, cfg)
        out.append((s, occ.cull_per_ray(s, 16)))
    for want, got in zip(*out):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("R,adaptive", [(64, True), (24, False)])
def test_grid_update_on_card_matches_cpu(cuda_device, R, adaptive):
    """The same draws give the same cells and, up to float32 rounding of
    sigma, the same grid; R = 24 divides by a number that is not a power of
    two."""
    from hashnerf_torch.render import occupancy as occ

    grid, _ = occ_inputs(R=R, seed=2)
    cfg = occ.OccupancyConfig(resolution=R, adaptive_update=adaptive, n_update_samples=8192)
    g = torch.Generator().manual_seed(3)
    n_half = 4096 if adaptive else 0
    draws = occ.OccUpdateDraws(
        uniform_cells=torch.randint(0, R**3, (8192 - n_half,), generator=g),
        block_sel=torch.randint(0, 1024, (n_half,), generator=g),
        offsets=torch.randint(-1, R // 32 + 1, (n_half, 3), generator=g),
        jitter=torch.rand((8192, 3), generator=g),
    )
    sigma_fn = lambda p: 2.0 - 3.0 * (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2]
    out = []
    for dev in ("cpu", cuda_device):
        gr, b = torch.from_numpy(grid).to(dev), torch.from_numpy(OCC_BBOX).to(dev)
        d = occ.OccUpdateDraws(*(t.to(dev) for t in draws))
        out.append((occ.sample_update_cells(gr, cfg, d).cpu(),
                    occ.update_occupancy_grid(gr, b, cfg, sigma_fn, d).cpu()))
    assert torch.equal(out[1][0], out[0][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_permute_rows_on_card_matches_cpu(cuda_device):
    from hashnerf_torch.kernels.gather import permute_rows

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3001, 32)).astype(np.float32)
    g = rng.normal(size=(3001, 32)).astype(np.float32)
    perm = rng.permutation(3001)
    inv = np.argsort(perm)
    out = []
    for dev in ("cpu", cuda_device):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        y = permute_rows(xt, torch.from_numpy(perm).to(dev), torch.from_numpy(inv).to(dev))
        y.backward(torch.from_numpy(g).to(dev))
        out.append((y.detach().cpu(), xt.grad.cpu()))
    assert torch.equal(out[1][0], out[0][0]) and torch.equal(out[1][1], out[0][1])
    assert torch.equal(out[0][1], torch.from_numpy(g[inv]))


# --------------------------------------------------------------------------- #
# Many steps a launch: run_steps' CUDA graphs
# --------------------------------------------------------------------------- #

GRAPH_SMALL = dict(N_rand=64, N_samples=16, N_importance=16, lrate=0.01, lrate_decay=10,
                   use_viewdirs=True, finest_res=64, log2_hashmap_size=12, white_bkgd=True,
                   no_batching=True, perturb=1.0, device="cuda")
GRAPH_FLAGSHIP = dict(GRAPH_SMALL, n_levels=4, n_features_per_level=8, log2_hashmap_size=13,
                      packed_layout=True, share_fine=True, aabb_clip=True, compute_dtype="bfloat16",
                      use_occupancy=True, occ_resolution=32, occ_warmup=4, occ_update_every=4,
                      occ_keep_fraction=0.125, occ_keep_coarse=0.375,
                      occ_keep_schedule="0:0.5,8:0.125", occ_block=8, occ_adaptive_update=True)
GRAPH_SETTINGS = {
    "chair": GRAPH_SMALL,
    "packed": dict(GRAPH_SMALL, n_levels=4, n_features_per_level=8, log2_hashmap_size=13,
                   packed_layout=True, share_fine=True, aabb_clip=True, compute_dtype="bfloat16"),
    "flagship": GRAPH_FLAGSHIP,
}


def graph_trainer(settings):
    """A small Trainer on the card, its tables scaled to U(-1, 1) (at the
    1e-4 init, sigma ~ 1e-5 makes alpha = 1 - exp(-sigma dt) cancel)."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    args = config_parser().parse_args([])
    for k, v in settings.items():
        setattr(args, k, v)
    t = Trainer(args, make_synthetic_scene(H=32, W=32, n_train=3, n_test=1), device="cuda")
    with torch.no_grad():
        for p in t.state.table_parameters():
            p.mul_(1e4)
    return t


def row_gate_ok(got, want):
    """|got - want| <= 2e-5 * sum(|want row|) + 1e-6: K5's and K6's atomics
    add in no fixed order."""
    for g, w in zip(got, want):
        w2 = w.reshape(-1, w.shape[-1]) if w.dim() > 1 else w.reshape(-1, 1)
        if not bool(((g.reshape(w2.shape) - w2).abs() <= 2e-5 * w2.abs().sum(-1, keepdim=True) + 1e-6).all()):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["chair", "packed", "flagship"])
def test_graphed_blocks_equal_eager_steps(cuda_device, which):
    """From one state and one generator state: 16 steps as run_steps(16)
    (captured, then 16 replays) and as 16 eager steps (after 8 eager steps
    that open RAdam's gate and, for the flagship, ready the grid)."""
    t = graph_trainer(GRAPH_SETTINGS[which])
    for _ in range(8):
        t.step(t.sample_batch(False))
    snap = [x.detach().clone() for x in t.training_state()]
    rng = t.generator.get_state()
    ready = t._occ_ready
    for _ in range(16):
        t.step(t.sample_batch(False))
    eager = [x.detach().clone() for x in t.training_state()]
    keep = t.last_occ_keep
    with torch.no_grad():
        for x, s in zip(t.training_state(), snap):
            x.copy_(s)
    t.generator.set_state(rng)
    t.global_step, t._occ_ready = 8, ready
    m = t.run_steps(16, block_size=16)
    assert t.global_step == 24 and t.last_occ_keep == keep
    assert ("step", True, which == "flagship", False, 0.125 if which == "flagship" else None) in t._graphs.graphs
    assert torch.isfinite(m["loss"]) and row_gate_ok(t.training_state(), eager)


def outside_row_gate(got, want) -> float:
    """The share of entries outside row_gate_ok's gate."""
    bad = total = 0
    for g, w in zip(got, want):
        w2 = w.reshape(-1, w.shape[-1]) if w.dim() > 1 else w.reshape(-1, 1)
        bad += int(((g.reshape(w2.shape) - w2).abs() > 2e-5 * w2.abs().sum(-1, keepdim=True) + 1e-6).sum())
        total += w2.numel()
    return bad / total


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["chair", "flagship"])
def test_graphed_pool_blocks_equal_eager_steps(cuda_device, which):
    """Ray batching: 16 steps as one run_steps block of 16 on the pool
    (captured, then 16 replays reading rows from the device offset) and as
    16 eager sample_pool steps on the same rows, from one state; then the pool is
    reshuffled in place and a second block replays the same graph on the
    new rows, again against eager steps on them. The last loss within 1e-4
    and at most 0.1% of the entries outside the atomics' row gate: after 16
    steps a few table entries whose gradients nearly cancel may leave it in
    either mode, where rows read at a stale offset or from a stale pool
    move most entries and the loss."""
    t = graph_trainer(GRAPH_SETTINGS[which])
    for _ in range(8):
        t.step(t.sample_batch(False))
    pool = t.build_ray_pool()
    for shuffle in (False, True):
        if shuffle:
            t.shuffle_pool(pool)
        snap = [x.detach().clone() for x in t.training_state()]
        rng, ready, start = t.generator.get_state(), t._occ_ready, t.global_step
        for k in range(16):
            me = t.step(t.sample_pool(pool, 64 * 16 + k * 64, 64))
        eager = [x.detach().clone() for x in t.training_state()]
        with torch.no_grad():
            for x, s in zip(t.training_state(), snap):
                x.copy_(s)
        t.generator.set_state(rng)
        t.global_step, t._occ_ready = start, ready
        m = t.run_steps(16, block_size=16, pool=pool, offset=64 * 16)
        assert t.global_step == start + 16
        assert abs(float(m["loss"]) - float(me["loss"])) <= 1e-4 * abs(float(me["loss"]))
        assert outside_row_gate(t.training_state(), eager) <= 1e-3
    assert sum(k[0] == "step" for k in t._graphs.graphs) == 1


@pytest.mark.cuda
def test_launch_counts_count_graph_replays(cuda_device):
    from hashnerf_torch.kernels import reset_launch_counts

    t = graph_trainer(GRAPH_SMALL)
    t.run_steps(16, block_size=16)  # the capture and 16 replays
    graph = t._graphs.graphs[("step", True, False, False, None)]
    # a TV step: K2 and K6 in each pass, K5 for the TV loss, K9 and field_raw
    # forward and backward in each pass, whose directions are encoded once a
    # ray; the MLPs' points of both passes (64 rays, 16 + 32 samples); one
    # step a replay
    assert graph.launches == {"hash_encode_fwd": 2, "hash_encode_bwd": 2, "segment_accumulate_k5": 1,
                              "field_colour_input_fwd": 2, "field_colour_input_bwd": 2,
                              "field_raw_fwd": 2, "field_raw_bwd": 2, "views_per_ray": 2,
                              "mlp_points": 64 * (16 + 32), "steps_replayed": 1}
    reset_launch_counts()
    t.run_steps(16, block_size=16)  # replays only
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {k: 16 * v for k, v in graph.launches.items()}
    # the flagship's grid update (a bf16 net, no gradient) runs the fused
    # forward in a graph of its own, and counts its points on each replay;
    # its training steps take gradients and run none
    t = graph_trainer(GRAPH_FLAGSHIP)
    for _ in range(8):
        t.step(t.sample_batch(False))
    reset_launch_counts()
    t.run_steps(16, block_size=16)
    update = t._graphs.graphs[("update",)]
    points = update.launches["mlp_points"]
    assert update.launches["field_mlp_fwd"] == 1 and update.launches["mlp_fused_points"] == points
    counts = launch_counts()
    assert counts["grid_updates"] >= 4
    assert counts["mlp_fused_points"] == counts["field_mlp_fwd"] * points == counts["grid_updates"] * points


# --------------------------------------------------------------------------- #
# K9 field_colour_input and field_raw: the field query's copies
# --------------------------------------------------------------------------- #

# (R, S): the render chunk's coarse and fine passes, the chair's training
# passes, the flagship's culled blocks of 8 and a grid update's points
FIELD_SHAPES = [(32768, 64), (32768, 192), (1024, 64), (1024, 192), (3072, 8), (4096, 1)]
FIELD_KERNELS = ("field_colour_input_fwd", "field_colour_input_bwd", "field_raw_fwd",
                 "field_raw_bwd")


def field_inputs(dev, R, S, seed=21):
    """(views (R, 16), h (N, 16), rgb (N, 3), keep (N,), g_c (N, 31),
    g_raw (N, 4)) on dev: SH-encoded unit directions and normal values, a
    fifth of the points outside the keep mask."""
    from hashnerf_torch.ops.sh_encoding import sh_encode

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    N = R * S
    d = torch.randn((R, 3), generator=gen, device=dev)
    views = sh_encode(d / d.norm(dim=-1, keepdim=True))
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    keep = torch.rand((N,), generator=gen, device=dev) < 0.8
    return views, normal(N, 16), normal(N, 3), keep, normal(N, 31), normal(N, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", FIELD_SHAPES)
def test_field_kernels_on_card_equal_plain(cuda_device, R, S):
    """Each of the four launches against its plain version on the CPU, bit
    for bit (pure data movement), one launch each; the colour input's pad
    column +0."""
    from hashnerf_torch.kernels import field_query as fq

    views, h, rgb, keep, g_c, g_raw = field_inputs(cuda_device, R, S)
    N = R * S
    cpu = lambda *ts: [t.cpu() for t in ts]
    before = launch_counts()
    c = fq.field_colour_input_fwd(views, h, S)
    d_h = fq.field_colour_input_bwd(g_c, 16, 16)
    raw = fq.field_raw_fwd(rgb, h, keep)
    d_h_raw = fq.field_raw_bwd(g_raw, keep, 16)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == dict.fromkeys(
        FIELD_KERNELS, 1)
    assert c.shape == (N, 31) and c.stride() == (32, 1)
    assert torch.equal(c.cpu(), fq.field_colour_input_fwd_plain(*cpu(views, h), S))
    assert not c.as_strided((N, 32), (32, 1))[:, 31].any()
    assert torch.equal(d_h.cpu(), fq.field_colour_input_bwd_plain(g_c.cpu(), 16, 16))
    assert torch.equal(raw.cpu(), fq.field_raw_fwd_plain(*cpu(rgb, h, keep)))
    assert torch.equal(d_h_raw.cpu(), fq.field_raw_bwd_plain(*cpu(g_raw, keep), 16))


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(1024, 64), (3072, 8), (4096, 1)])
def test_field_functions_on_card_equal_cpu(cuda_device, R, S):
    """The autograd Functions as NeRFSmall calls them: the colour input and
    the raw, and the gradients of h and rgb, on the card and on the CPU."""
    from hashnerf_torch.kernels.field_query import field_colour_input, field_raw

    views, h, rgb, keep, g_c, g_raw = field_inputs(cuda_device, R, S, seed=22)

    def run(views, h, rgb, keep, g_c, g_raw):
        h = h.clone().requires_grad_(True)
        rgb = rgb.clone().requires_grad_(True)
        c = field_colour_input(views, h, S)
        raw = field_raw(rgb, h, keep)
        ((c * g_c).sum() + (raw * g_raw).sum()).backward()
        return [t.detach().cpu() for t in (c, raw, h.grad, rgb.grad)]

    ins = (views, h, rgb, keep, g_c, g_raw)
    for got, want in zip(run(*ins), run(*[t.cpu() for t in ins])):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_encode_on_card_writes_the_stacked_columns(cuda_device, degree):
    """sh_encode's in-place column products on the card equal the stacked
    formulation on the card, bit for bit, at a render chunk's rays."""
    from hashnerf_torch.ops.sh_encoding import sh_encode
    from test_torch_field_query import old_sh_encode

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(23)
    d = torch.randn((32768, 3), generator=gen, device=cuda_device)
    d = d / d.norm(dim=-1, keepdim=True)
    assert torch.equal(sh_encode(d, degree), old_sh_encode(d, degree))


@pytest.mark.cuda
def test_field_kernels_refuse_what_they_cannot_take(cuda_device):
    """A launch the entry refuses raises through build.check (the wrappers'
    route); the wrappers raise before launching on a wrong type or a second
    device, and take no plain path for a CUDA tensor."""
    from hashnerf_torch.kernels import KERNELS, build
    from hashnerf_torch.kernels import field_query as fq

    dev = cuda_device
    h, rgb = torch.zeros((8, 16), device=dev), torch.zeros((8, 3), device=dev)
    out = torch.empty((8, 32), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    before = launch_counts()
    fwd = KERNELS["field_colour_input_fwd"].fn
    # rows of 31 floats are no whole 16-byte vectors; 3 samples a ray do not divide 8 rows
    for P, S in ((31, 1), (32, 3)):
        err = fwd(None, h.data_ptr(), out.data_ptr(), 8, S, 0, 15, P, 0, 16, stream)
        with pytest.raises(RuntimeError, match="field_colour_input_fwd"):
            build.check(err, "field_colour_input_fwd")
    # raw rows must be 16-byte aligned
    err = KERNELS["field_raw_fwd"].fn(rgb.data_ptr(), h.data_ptr(), None, out.data_ptr() + 4, 8,
                                      3, 16, stream)
    with pytest.raises(RuntimeError, match="field_raw_fwd"):
        build.check(err, "field_raw_fwd")
    with pytest.raises(TypeError):
        fq.field_raw_fwd(rgb.double(), h, None)
    with pytest.raises(ValueError):
        fq.field_raw_fwd(rgb, h.cpu(), None)
    with pytest.raises(ValueError):
        fq.field_colour_input_fwd(None, h, 3)
    torch.cuda.synchronize()
    assert launch_counts() == before


# --------------------------------------------------------------------------- #
# field_mlp: NeRFSmall's one-kernel bf16 and float32 forward
# --------------------------------------------------------------------------- #

# (R, S): the render chunk's coarse and fine passes, a grid update's points,
# and 7,007 points, which are no whole number of the kernel's 16-point tiles
MLP_SHAPES = [(32768, 64), (32768, 192), (65536, 1), (1001, 7)]


def mlp_case(dev, R, S, views=True, seed=24, dtype="bfloat16"):
    """A NeRFSmall of compute_dtype dtype (bf16, or None: float32), its five
    weights on dev and (x (N, 32), views (R, 16) or None, keep (N,)): normal
    encoded points, SH-encoded unit directions, a fifth of the points
    outside the keep mask."""
    from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig
    from hashnerf_torch.ops.sh_encoding import sh_encode

    cfg = NeRFSmallConfig(compute_dtype=dtype, input_ch_views=16 if views else 0)
    net = NeRFSmall(cfg, torch.Generator().manual_seed(seed)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    N = R * S
    x = torch.randn((N, 32), generator=gen, device=dev)
    d = torch.randn((R, 3), generator=gen, device=dev)
    v = sh_encode(d / d.norm(dim=-1, keepdim=True)) if views else None
    keep = torch.rand((N,), generator=gen, device=dev) < 0.8
    return net, [l.weight.detach() for l in [*net.sigma_net, *net.color_net]], x, v, keep


def assert_reordered_sums_close(got, want):
    """The kernel sums each output's exact bf16 products in k order; the
    PyTorch route on the card (cuBLAS float32 GEMMs of the same operands)
    does too but for rare last bits at a million rows and more, and in
    other orders at a few thousand rows. Alone that moves a value by about
    1e-7 of its column's largest magnitude; where it flips a hidden value's
    bf16 rounding, that value moves by one bf16 ulp (2^-8 to 2^-7 of
    itself) and the outputs after it by a share of that. So: at most 0.2%
    of the entries beyond 1e-5 of their column's scale, and every entry
    within 2^-6 of it (a kernel summing in another order, on the tensor
    cores, measured 0.03-0.06% and at most 2^-7.9 against this route)."""
    scale = want.abs().amax(0)
    err = (got - want).abs()
    assert float((err > 1e-5 * scale).float().mean()) <= 2e-3
    assert bool((err <= 2.0 ** -6 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("views", [True, False], ids=["views", "no_views"])
@pytest.mark.parametrize("R,S", MLP_SHAPES)
def test_field_mlp_on_card_matches_the_pytorch_route(cuda_device, R, S, views):
    """The kernel equals its arithmetic in PyTorch ops with every sum in k
    order (field_mlp_fwd_ordered) bit for bit; against the PyTorch route on
    the same card tensors (its plain version, and NeRFSmall's autograd
    route), see assert_reordered_sums_close. Exact: sigma 0 outside the
    keep mask, two launches equal bit for bit (no atomics), one launch
    each."""
    from hashnerf_torch.kernels import field_mlp as fm

    net, ws, x, v, keep = mlp_case(cuda_device, R, S, views)
    bf = torch.bfloat16
    before = launch_counts()
    with torch.no_grad():
        got = fm.field_mlp_fwd(x, v, S, keep, ws, bf)
        again = fm.field_mlp_fwd(x, v, S, keep, ws, bf)
        want = fm.field_mlp_fwd_plain(x, v, S, keep, ws, bf)
        ordered = fm.field_mlp_fwd_ordered(x, v, S, keep, ws, bf)
    routed = net.forward_rays(x, v, S, keep).detach()
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["field_mlp_fwd"] - before["field_mlp_fwd"] == 2
    assert got.shape == (R * S, 4) and torch.isfinite(got).all()
    assert torch.equal(got, ordered)
    assert_reordered_sums_close(got, want)
    assert_reordered_sums_close(got, routed)
    assert (got[~keep, 3] == 0).all() and (want[~keep, 3] == 0).all()
    assert torch.equal(got, again)


# (R, S): the chair render chunk's coarse and fine passes (N = 2,097,152 and
# 6,291,456), and 7,007 points, no whole number of the kernel's 256-point
# groups
MLP_F32_SHAPES = [(32768, 64), (32768, 192), (1001, 7)]
# field_mlp_fwd_f32 against the PyTorch route: the largest gap over its
# column's largest magnitude
MLP_F32_GAP = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("views", [True, False], ids=["views", "no_views"])
@pytest.mark.parametrize("R,S", MLP_F32_SHAPES)
def test_field_mlp_f32_on_card_matches_the_pytorch_route(cuda_device, R, S, views):
    """The float32 kernel equals its arithmetic in PyTorch ops, each
    output's fmaf chain in k order (field_mlp_fwd_ordered), bit for bit.
    Against the PyTorch route on the same card tensors (its plain version,
    and NeRFSmall's autograd route: cuBLAS float32 GEMMs, which add in the
    same order but for rare last bits), every entry is within MLP_F32_GAP
    of its column's largest magnitude; the share of entries equal to it is
    printed (pytest -rP shows it). Exact: sigma 0 outside the keep mask, two launches equal bit
    for bit, one launch each."""
    from hashnerf_torch.kernels import field_mlp as fm

    net, ws, x, v, keep = mlp_case(cuda_device, R, S, views, dtype=None)
    before = launch_counts()
    with torch.no_grad():
        got = fm.field_mlp_fwd(x, v, S, keep, ws, None)
        again = fm.field_mlp_fwd(x, v, S, keep, ws, None)
        want = fm.field_mlp_fwd_plain(x, v, S, keep, ws, None)
        ordered = fm.field_mlp_fwd_ordered(x, v, S, keep, ws, None)
    routed = net.forward_rays(x, v, S, keep).detach()
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["field_mlp_fwd_f32"] - before["field_mlp_fwd_f32"] == 2
    assert after["field_mlp_fwd"] == before["field_mlp_fwd"]
    assert got.shape == (R * S, 4) and torch.isfinite(got).all()
    assert torch.equal(got, ordered)
    for name, ref in (("plain", want), ("route", routed)):
        gap = float(((got - ref).abs() / ref.abs().amax(0)).max())
        print(f"N {R * S}: {float((got == ref).float().mean()):.7f} of the entries equal to the "
              f"{name}, the largest gap {gap:.3g} of a column's largest magnitude")
        assert gap <= MLP_F32_GAP, (name, gap)
    assert (got[~keep, 3] == 0).all() and (want[~keep, 3] == 0).all()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", None], ids=["bf16", "f32"])
def test_field_mlp_replays_from_a_cuda_graph(cuda_device, dtype):
    """A captured launch replays bit for bit what the eager launch wrote,
    through NeRFSmall's no-grad route (a render chunk's fine pass), on new
    inputs copied into the captured ones."""
    net, ws, x, v, keep = mlp_case(cuda_device, 4096, 192, dtype=dtype)
    S = 192
    with torch.no_grad():
        eager = net.forward_rays(x, v, S, keep)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            net.forward_rays(x, v, S, keep)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        x_in, v_in, keep_in = x.clone(), v.clone(), keep.clone()
        x_in.zero_()
        with torch.cuda.graph(graph):
            captured = net.forward_rays(x_in, v_in, S, keep_in)
        x_in.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        _, _, x2, v2, keep2 = mlp_case(cuda_device, 4096, 192, seed=25, dtype=dtype)
        x_in.copy_(x2), v_in.copy_(v2), keep_in.copy_(keep2)
        graph.replay()
        want = net.forward_rays(x2, v2, S, keep2)
        torch.cuda.synchronize()
        assert torch.equal(captured, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounding", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_field_mlp_refuses_what_it_cannot_take(cuda_device, rounding):
    """A launch either entry refuses raises through build.check; the
    wrapper raises before launching on a wrong shape or a second device,
    and takes no plain path for a CUDA tensor."""
    from hashnerf_torch.kernels import KERNELS, build
    from hashnerf_torch.kernels import field_mlp as fm

    _, ws, x, v, keep = mlp_case(cuda_device, 8, 4)
    raw = torch.empty((32, 4), device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    before = launch_counts()
    ptrs = [w.data_ptr() for w in ws]
    # rows of 30 floats are no whole 16-byte vectors; 3 samples a ray do not divide 32 rows;
    # a raw misaligned by a float
    entry = fm._KERNELS[rounding].entry
    for sx, S, out in ((30, 4, raw.data_ptr()), (32, 3, raw.data_ptr()),
                       (32, 4, raw.data_ptr() + 4)):
        err = KERNELS[entry].fn(x.data_ptr(), v.data_ptr(), keep.data_ptr(), *ptrs, out, 32, S, 16,
                                sx, 16, stream)
        with pytest.raises(RuntimeError, match=entry):
            build.check(err, entry)
    with pytest.raises(ValueError):
        fm.field_mlp_fwd(x, v.cpu(), 4, keep, ws, rounding)
    with pytest.raises(ValueError, match="weights"):
        fm.field_mlp_fwd(x, None, 4, keep, ws, rounding)
    torch.cuda.synchronize()
    assert launch_counts() == before


# --------------------------------------------------------------------------- #
# K7 / K8: the packed encode
# --------------------------------------------------------------------------- #

# K7 and its plain version sum the same 8 float32 products in other orders:
# each within gamma_7 of their absolute sum from the exact sum
# (chip_smoke.py's BLEND_ORDER_RTOL).
PACKED_BLEND_RTOL = 2 * 7 * 2.0**-24 / (1 - 7 * 2.0**-24)


def packed_on_card(dev, name, family, n=4001, scale=1e4):
    """(dense, fine, x, bmin, bmax, g, cfg) on the card: the tables x scale
    (so that a wrong row cannot hide under the gates' absolute terms), n
    points of the family (not a multiple of 32: a warp tail)."""
    cfg = packed_config(name)
    tabs = packed_tables(cfg, 11)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x = packed_points(cfg, family, n, 12)
    g = np.random.default_rng(13).normal(size=(n, cfg.out_dim)).astype(np.float32)
    dense = to(tabs["dense"] * scale) if "dense" in tabs else None
    fine = to(tabs["fine"] * scale) if "fine" in tabs else None
    return dense, fine, to(x), to(np.full(3, -1.5, np.float32)), to(np.full(3, 1.5, np.float32)), to(g), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("family", PACKED_FAMILIES)
@pytest.mark.parametrize("name", list(PACKED_CONFIGS))
def test_k7_k8_on_card_match_plain(cuda_device, name, family):
    dense, fine, x, bmin, bmax, g, cfg = packed_on_card(cuda_device, name, family)
    before = launch_counts()
    feats, keep = pe.packed_encode_fwd(dense, fine, x, bmin, bmax, cfg)
    d_dense, d_fine = pe.packed_encode_bwd(x, bmin, bmax, g, cfg)
    after = launch_counts()
    assert all(after[k] == before[k] + (k in ("packed_encode_fwd", "packed_encode_bwd")) for k in after)
    torch.cuda.synchronize()
    want, want_keep = pe.packed_encode_fwd_plain(dense, fine, x, bmin, bmax, cfg)
    abs_sum, _ = pe.packed_encode_fwd_plain(None if dense is None else dense.abs(),
                                            None if fine is None else fine.abs(), x, bmin, bmax, cfg)
    assert torch.equal(keep, want_keep)
    assert bool(((feats - want).abs() <= PACKED_BLEND_RTOL * abs_sum).all())
    # atomics add in an order that changes from run to run: each entry may
    # differ from the plain version by 2e-5 of its row's absolute sum
    plain = pe.packed_encode_bwd_plain(x, bmin, bmax, g, cfg)
    for got, want_d, table in zip((d_dense, d_fine), plain, (dense, fine)):
        assert (got is None) == (want_d is None) == (table is None)
        if got is not None:
            assert got.shape == table.shape and float(want_d.abs().max()) > 0
            assert row_gate_ok([got], [want_d])


@pytest.mark.cuda
def test_k7_k8_at_flagship_widths_match_plain(cuda_device):
    """L4 / F8 at log2 T 19, 2^16 block rows, finest 512 (two dense levels,
    res 16 and 50; two hashed, 161 and 511), 65,536 points along rays."""
    from hashnerf_torch.ops.packed_grid import PackedGridConfig

    cfg = PackedGridConfig(n_levels=4, n_features_per_level=8, log2_hashmap_size=19,
                           finest_resolution=512, log2_blocks=16)
    rng = np.random.default_rng(14)
    dev = cuda_device
    o = rng.uniform(-1.6, 1.6, (1024, 1, 3))
    d = rng.normal(size=(1024, 1, 3))
    x = (o + np.linspace(0, 1.2, 64)[None, :, None] * d / np.linalg.norm(d, axis=-1, keepdims=True))
    x = torch.from_numpy(x.reshape(-1, 3).astype(np.float32)).to(dev)
    dshape, fshape = table_shapes(cfg)
    dense = torch.from_numpy(rng.normal(size=dshape).astype(np.float32) * 1e4).to(dev)
    fine = torch.from_numpy(rng.normal(size=fshape).astype(np.float32) * 1e4).to(dev)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], cfg.out_dim)).astype(np.float32)).to(dev)
    bmin, bmax = torch.full((3,), -1.5, device=dev), torch.full((3,), 1.5, device=dev)
    feats, keep = pe.packed_encode_fwd(dense, fine, x, bmin, bmax, cfg)
    want, want_keep = pe.packed_encode_fwd_plain(dense, fine, x, bmin, bmax, cfg)
    abs_sum, _ = pe.packed_encode_fwd_plain(dense.abs(), fine.abs(), x, bmin, bmax, cfg)
    assert torch.equal(keep, want_keep) and bool(keep.any()) and not bool(keep.all())
    assert bool(((feats - want).abs() <= PACKED_BLEND_RTOL * abs_sum).all())
    got = pe.packed_encode_bwd(x, bmin, bmax, g, cfg)
    assert row_gate_ok(list(got), list(pe.packed_encode_bwd_plain(x, bmin, bmax, g, cfg)))


@pytest.mark.cuda
def test_packed_encode_on_card_launches_k7_k8(cuda_device):
    """ops/packed_grid.py::packed_encode on CUDA tensors is PackedEncode
    (K7, then K8 in the backward), never the torch-ops route (no K5), and
    refuses tables and points on two devices."""
    from hashnerf_torch.ops.packed_grid import packed_encode

    dense, fine, x, bmin, bmax, g, cfg = packed_on_card(cuda_device, "L4_F8", "outside")
    tables = {"dense": dense.requires_grad_(True), "fine": fine.requires_grad_(True)}
    before = launch_counts()
    feats, _ = packed_encode(tables, x, bmin, bmax, cfg)
    (feats * g).sum().backward()
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "packed_encode_fwd": 1, "packed_encode_bwd": 1}
    want = pe.packed_encode_bwd_plain(x, bmin, bmax, g, cfg)
    assert row_gate_ok([tables["dense"].grad, tables["fine"].grad], list(want))
    with pytest.raises(ValueError):
        packed_encode(tables, x.cpu(), bmin, bmax, cfg)


@pytest.mark.cuda
def test_packed_graph_replays_launch_k7_k8(cuda_device):
    """A packed TV step's graph launches K7 and K8 in each pass and K5 only
    for the TV loss's gathers; replays count them."""
    from hashnerf_torch.kernels import reset_launch_counts

    t = graph_trainer(GRAPH_SETTINGS["packed"])
    t.run_steps(16, block_size=16)  # the capture and 16 replays
    graph = t._graphs.graphs[("step", True, False, False, None)]
    assert graph.launches["packed_encode_fwd"] == 2 and graph.launches["packed_encode_bwd"] == 2
    assert graph.launches["segment_accumulate_k5"] >= 1
    assert not any(graph.launches.get(k) for k in ("hash_encode_fwd", "hash_encode_bwd"))
    reset_launch_counts()
    t.run_steps(16, block_size=16)  # replays only
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {k: 16 * v for k, v in graph.launches.items() if v}


# --------------------------------------------------------------------------- #
# K6 / K8 on zero cotangent rows and hot rows (both skip a lane whose
# cotangent row is zero; K6 groups a hashed level's lanes by runs)
# --------------------------------------------------------------------------- #

def with_zero_rows(g, L, seed):
    """g (N, L*F) with exactly-zero (point, level) rows: every level of
    points 0-63 (two whole warps) and of the last 33 points (the tail
    warp, past N included), a third of the other rows at random, some of
    them -0.0."""
    rng = np.random.default_rng(seed)
    N = g.shape[0]
    rows = g.reshape(N, L, -1).clone()
    zero = torch.from_numpy(rng.random((N, L)) < 1 / 3).to(g.device)
    zero[:64] = True
    zero[-33:] = True
    rows[zero] = 0.0
    neg = zero & torch.from_numpy(rng.random((N, L)) < 0.5).to(g.device)
    rows[neg] = -0.0
    return rows.reshape(N, -1).contiguous()


def on_faces(x, lo, hi, seed, n_faces=600, n_hi=200):
    """x with n_faces points moved outside the bbox on one to three axes
    (clipped onto its faces, edges and corners: hot rows), then n_hi points
    exactly at hi on one to three axes (xc = hi: b = res)."""
    rng = np.random.default_rng(seed)
    x = x.clone()
    n = x.shape[0]
    pick = rng.choice(np.arange(64, n - 33), n_faces + n_hi, replace=False)
    for rows, value in ((pick[:n_faces], None), (pick[n_faces:], hi)):
        axes = rng.random((len(rows), 3)) < 0.5
        axes[np.arange(len(rows)), rng.integers(0, 3, len(rows))] = True
        far = rng.choice([lo - 1.0, hi + 1.0], (len(rows), 3)) if value is None else np.full(
            (len(rows), 3), value)
        sub = x[torch.from_numpy(rows)].cpu().numpy()
        sub[axes] = far[axes]
        x[torch.from_numpy(rows)] = torch.from_numpy(sub.astype(np.float32)).to(x.device)
    return x


def k6_rows_ok(got, args, g, T):
    """K6 against its plain version in the row gate of its terms' absolute
    sums (atomics add in no fixed order)."""
    plain = he.hash_encode_bwd_plain(*args, g, T)
    abs_sum = he.hash_encode_bwd_plain(*args, g.abs(), T)
    return got.shape == plain.shape and bool(((got - plain).abs() <= 2e-5 * abs_sum + 1e-6).all())


def k8_rows_ok(got, x, bmin, bmax, g, cfg):
    plain = pe.packed_encode_bwd_plain(x, bmin, bmax, g, cfg)
    abs_sum = pe.packed_encode_bwd_plain(x, bmin, bmax, g.abs(), cfg)
    for a, p, s in zip(got, plain, abs_sum):
        if (a is None) != (p is None):
            return False
        if a is not None and not (a.shape == p.shape and bool(((a - p).abs() <= 2e-5 * s + 1e-6).all())):
            return False
    return True


def hard_k6_inputs(dev, F, log2_T):
    """K6 inputs at the chair's levels (L16 from res 16 to 512): 4001
    points (a warp tail) in the bbox grown by 20%, a tenth on grid
    vertices, 800 moved onto the faces or to hi (on_faces), and a
    cotangent with zero rows, whole warps too (with_zero_rows). At log2 T
    19 levels 0-6 are collision-free (match grouping) and 7-15 hashed
    (runs); at 12 every level is hashed."""
    cfg = HashGridConfig(n_levels=16, n_features_per_level=F, log2_hashmap_size=log2_T)
    rng = np.random.default_rng(5)
    x = snap_to_vertices(rng.uniform(-2.24, 2.24, (4001, 3)).astype(np.float32), cfg, -1.6, 1.6,
                         0.1, seed=6)
    to = lambda a: torch.from_numpy(a).to(dev)
    x = on_faces(to(x), -1.6, 1.6, seed=8)
    g = with_zero_rows(to(rng.normal(size=(4001, 16 * F)).astype(np.float32)), 16, seed=9)
    box = [torch.full((3,), v, device=dev) for v in (-1.6, 1.6)]
    return [x, *box, cfg.resolutions_tensor(dev)], g, cfg.table_size


@pytest.mark.cuda
@pytest.mark.parametrize("log2_T", [12, 19])
@pytest.mark.parametrize("group_levels", [1, 4, 16])
@pytest.mark.parametrize("F", [1, 2, 3, 8])
def test_k6_zero_and_hot_rows_on_card_match_plain(cuda_device, monkeypatch, F, group_levels,
                                                  log2_T):
    monkeypatch.setattr(he, "_K6_GROUP_LEVELS", group_levels)
    args, g, T = hard_k6_inputs(cuda_device, F, log2_T)
    before = launch_counts()
    got = he.hash_encode_bwd(*args, g, T)
    after = launch_counts()
    assert all(after[n] == before[n] + (n == "hash_encode_bwd") for n in after)
    assert k6_rows_ok(got, args, g, T)


@pytest.mark.cuda
@pytest.mark.parametrize("group_levels", [1, 4])
@pytest.mark.parametrize("name", list(PACKED_CONFIGS))
def test_k8_zero_and_hot_rows_on_card_match_plain(cuda_device, monkeypatch, name, group_levels):
    """K8 on 1000 points of each packed family (vertices, faces, outside,
    block edges) and one at hi, with zero cotangent rows (whole warps
    too)."""
    monkeypatch.setattr(pe, "_K8_GROUP_LEVELS", group_levels)
    cfg = packed_config(name)
    dev = cuda_device
    x = np.concatenate([packed_points(cfg, fam, 1000, 20 + k) for k, fam in enumerate(PACKED_FAMILIES)]
                       + [np.full((1, 3), 1.5, np.float32)])
    x = torch.from_numpy(x).to(dev)
    g = torch.from_numpy(np.random.default_rng(21).normal(size=(x.shape[0], cfg.out_dim))
                         .astype(np.float32)).to(dev)
    g = with_zero_rows(g, cfg.n_levels, seed=22)
    bmin, bmax = torch.full((3,), -1.5, device=dev), torch.full((3,), 1.5, device=dev)
    before = launch_counts()
    got = pe.packed_encode_bwd(x, bmin, bmax, g, cfg)
    after = launch_counts()
    assert all(after[n] == before[n] + (n == "packed_encode_bwd") for n in after)
    assert k8_rows_ok(got, x, bmin, bmax, g, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["k6", "k8"])
def test_encode_bwd_graph_capture_and_replay_on_card(cuda_device, which):
    """K6 (chair levels at log2 T 19) and K8 (L4 / F8), each captured in a
    CUDA graph with its zero fill and replayed on two cotangents (the
    second with zero rows) copied into the captured input: each replay
    within the row gate of its plain version; the capture counts one
    launch."""
    from hashnerf_torch.ops.packed_grid import PackedGridConfig

    dev = cuda_device
    if which == "k6":
        args, g0, T = hard_k6_inputs(dev, 2, 19)
        call = lambda: he.hash_encode_bwd(*args, g, T)
        ok = lambda out, gk: k6_rows_ok(out, args, gk, T)
        counter = "hash_encode_bwd"
    else:
        cfg = PackedGridConfig(n_levels=4, n_features_per_level=8, log2_hashmap_size=13,
                               finest_resolution=64, log2_blocks=10)
        x = torch.from_numpy(np.concatenate([packed_points(cfg, fam, 1000, 30 + k)
                                             for k, fam in enumerate(PACKED_FAMILIES)])).to(dev)
        bmin, bmax = torch.full((3,), -1.5, device=dev), torch.full((3,), 1.5, device=dev)
        g0 = torch.randn((x.shape[0], cfg.out_dim), device=dev)
        call = lambda: pe.packed_encode_bwd(x, bmin, bmax, g, cfg)
        ok = lambda out, gk: k8_rows_ok(out, x, bmin, bmax, gk, cfg)
        counter = "packed_encode_bwd"
    L = g0.shape[1] // (2 if which == "k6" else 8)
    g = g0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()  # build, load and warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()[counter]
    with torch.cuda.graph(graph):
        out = call()
    assert launch_counts()[counter] == before + 1
    for k, gk in enumerate((g0, with_zero_rows(-2.0 * g0, L, seed=31))):
        g.copy_(gk)
        graph.replay()
        torch.cuda.synchronize()
        assert ok(out, gk), k


@pytest.mark.cuda
def test_try_restore_drops_the_graphs(cuda_device, tmp_path):
    t = graph_trainer(GRAPH_SMALL)
    t.run_steps(16, block_size=16)
    t.save(str(tmp_path / "000016.ckpt"))
    assert t._graphs is not None and t._graphs.graphs
    m0 = t.run_steps(16, block_size=16)
    assert t.try_restore(str(tmp_path)) and t.global_step == 16
    assert t._graphs is None
    m1 = t.run_steps(16, block_size=16)  # captured anew, on the restored optimizer state
    assert t._graphs is not None and torch.isfinite(m1["loss"]) and torch.isfinite(m0["loss"])


# --------------------------------------------------------------------------- #
# The NeRF family and st3d's column pool (slice 9)
# --------------------------------------------------------------------------- #

ST3D_SMALL = dict(N_rand=64, N_samples=16, N_importance=16, lrate=5e-3, lrate_decay=10,
                  use_viewdirs=True, perturb=1.0, raw_noise_std=1.0, dataset_type="st3d",
                  use_depth=True, use_gradient=True, device="cuda")
ST3D_SETTINGS = {
    "omninerf": dict(ST3D_SMALL, i_embed=0, i_embed_views=0, multires=10, multires_views=4,
                     netdepth=8, netwidth=64, netdepth_fine=8, netwidth_fine=64),
    "st3d_hash": dict(ST3D_SMALL, finest_res=64, log2_hashmap_size=12),
}


def st3d_trainer(settings, n_rays=64 * 64):
    """A Trainer on st3d's scene with a column pool of n_rays random rays
    from around the origin (depth and gradient columns), on the card."""
    from hashnerf_torch.data.st3d import st3d_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    args = config_parser().parse_args([])
    for k, v in settings.items():
        setattr(args, k, v)
    t = Trainer(args, st3d_scene(512, 1024), device="cuda")
    with torch.no_grad():
        for p in t.state.table_parameters():
            p.mul_(1e4)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pool = t.build_column_pool({
        "rays_o": rng.uniform(-0.1, 0.1, (n_rays, 3)).astype(np.float32), "rays_d": d,
        "target": rng.uniform(0, 1, (n_rays, 3)).astype(np.float32),
        "target_depth": rng.uniform(0.3, 1, n_rays).astype(np.float32),
        "target_grad": rng.uniform(-1, 1, (n_rays, 3)).astype(np.float32)})
    return t, pool


@pytest.mark.cuda
@pytest.mark.parametrize("gradient", [False, True], ids=["nerf", "nerf_gradient"])
def test_nerf_family_on_card_matches_cpu(cuda_device, gradient):
    """Positional NeRF / NeRFGradient 8 x 256 (OmniNeRF's widths) from one
    state: raw on the card against the CPU at rtol 1e-4 / atol 1e-5; the
    MLP gradients held as chip_smoke.py holds OmniNeRF's step: the card's
    largest error against a float64 CPU pass (||g - g64|| / ||g64|| of a
    tensor) at most ST3D_F32_ERR_FACTOR x the CPU float32 pass's own, plus
    1e-6 (sums over 4,096 points in other orders, ReLUs that switch; TF32
    is off)."""
    import copy

    import chip_smoke
    from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn

    cfg = ModelConfig(i_embed=0, i_embed_views=0, use_gradient=gradient, N_importance=8)
    cpu = NGPState(cfg, torch.Generator().manual_seed(0))
    f64 = copy.deepcopy(cpu).double()
    card = NGPState(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-2, 2, (256, 16, 3)))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(256, 3))), dim=-1)
    bbox = torch.tensor([[-2.0] * 3, [2.0] * 3], dtype=torch.float64)
    outs = {}
    for name, st, dev, dt in (("cpu", cpu, "cpu", torch.float32), ("f64", f64, "cpu", torch.float64),
                              ("card", card, cuda_device, torch.float32)):
        raw = query_fn(st, pts.to(dev, dt), vd.to(dev, dt), bbox.to(dev, dt), fine=True)
        raw.square().sum().backward()
        outs[name] = (raw.detach().cpu(), [p.grad.cpu().double() for p in st.fine.parameters()])
    assert outs["card"][0].shape == (256, 16, 7 if gradient else 4)
    torch.testing.assert_close(outs["card"][0], outs["cpu"][0], rtol=1e-4, atol=1e-5)
    err = {k: max(float((g - r).norm() / r.norm()) for g, r in zip(outs[k][1], outs["f64"][1]))
           for k in ("card", "cpu")}
    assert err["card"] <= chip_smoke.ST3D_F32_ERR_FACTOR * err["cpu"] + 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["omninerf", "st3d_hash"])
def test_graphed_column_pool_blocks_equal_eager_steps(cuda_device, which):
    """st3d's column pool (13 floats a row): 16 steps as one run_steps block
    (captured, then replayed at the device offset) against 16 eager
    sample_pool steps on the same rows, from one state, with depth and
    gradient supervision, and Adam's (or RAdam's) step count on the device:
    the last loss within 1e-4, at most 0.1% of the entries outside the row
    gate; then a reshuffle in place and the same graph on the new rows."""
    t, pool = st3d_trainer(ST3D_SETTINGS[which])
    for k in range(4):
        t.step(t.sample_pool(pool, k * 64, 64))
    for shuffle in (False, True):
        if shuffle:
            t.shuffle_pool(pool, np.random.default_rng(1).permutation(pool.shape[0]))
        snap = [x.detach().clone() for x in t.training_state()]
        rng, start = t.generator.get_state(), t.global_step
        for k in range(16):
            me = t.step(t.sample_pool(pool, 1024 + k * 64, 64))
        eager = [x.detach().clone() for x in t.training_state()]
        with torch.no_grad():
            for x, s_ in zip(t.training_state(), snap):
                x.copy_(s_)
        t.generator.set_state(rng)
        t.global_step = start
        m = t.run_steps(16, block_size=16, pool=pool, offset=1024)
        assert abs(float(m["loss"]) - float(me["loss"])) <= 1e-4 * abs(float(me["loss"]))
        assert outside_row_gate(t.training_state(), eager) <= 1e-3
    assert sum(k[0] == "step" for k in t._graphs.graphs) == 1


@pytest.mark.cuda
def test_render_given_rays_on_card_matches_cpu(cuda_device):
    """render(rays=...) of NeRFGradient, as eval_test_omninerf renders a
    panorama: rgb and the composited gradient head (grad_map) on the card
    against the CPU, each within jax_view_close's mean and largest error."""
    import chip_smoke
    from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn
    from hashnerf_torch.ops.rays import equirect_directions
    from hashnerf_torch.render.renderer import RenderConfig, render

    cfg = ModelConfig(i_embed=0, i_embed_views=0, use_gradient=True, N_importance=32,
                      netwidth=64, netwidth_fine=64)
    cpu = NGPState(cfg, torch.Generator().manual_seed(0))
    card = NGPState(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    d = torch.from_numpy(equirect_directions(32, 64).reshape(-1, 3))
    o = torch.zeros_like(d)
    rcfg = RenderConfig(N_samples=32, N_importance=32, perturb=False)
    out = {}
    for st, dev in ((cpu, "cpu"), (card, cuda_device)):
        rgb, _, _, extras = render(st, query_fn, 32, 64, None, torch.tensor(
            [[-2.0] * 3, [2.0] * 3], device=dev), rcfg, chunk=512, near=0.0, far=2.0, rays=(o, d))
        out[dev if dev == "cpu" else "card"] = (rgb.cpu(), extras["grad_map"].cpu())
    assert out["card"][0].shape == (32 * 64, 3) and out["card"][1].shape == (32 * 64, 3)
    for i, what in enumerate(("rgb", "grad_map")):
        ok, err = chip_smoke.jax_view_close(out["card"][i].numpy(), out["cpu"][i].numpy())
        assert ok, (what, err)
    assert float(out["cpu"][1].abs().mean()) > 1e-3  # a head that is not all zero


@pytest.mark.cuda
def test_failed_capture_raises_without_eager_fallback(cuda_device, monkeypatch):
    """A host read inside the step cannot be captured: run_steps raises,
    runs no step, and leaves the state as it was. (Last in the file: the
    failed capture is the process's last.)"""
    t = graph_trainer(GRAPH_SMALL)
    t.step(t.sample_batch(False))
    train_one = t._train_one

    def with_host_read(*a, **k):
        m = train_one(*a, **k)
        float(m["loss"])
        return m

    monkeypatch.setattr(t, "_train_one", with_host_read)
    before = [x.detach().clone() for x in t.training_state()]
    rng = t.generator.get_state()
    with pytest.raises(RuntimeError):
        t.run_steps(16, block_size=16)
    assert t.global_step == 1
    assert all(torch.equal(x, y) for x, y in zip(t.training_state(), before))
    assert torch.equal(t.generator.get_state(), rng)


# --------------------------------------------------------------------------- #
# Multi-device training (slice 10)
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_nccl_world1_dp_step_equals_trainer_step(cuda_device):
    """One NCCL rank (--num_devices 1 in a process group of one, as
    chip_smoke.py's multi phase runs it on a one-card machine): each of 8
    steps from the one-process Trainer's seed, against Trainer.step on the
    same card: the same loss, MLP gradients bit-equal (the all-reduce over
    one rank copies), table gradients within the atomics' row gate."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_ranks as ranks
    from hashnerf_torch.parallel.mesh import launch

    res = launch(ranks.card_dp_rank, 1, "cuda")[0]
    assert res["backend"] == "nccl" and res["all_reduce_calls"] >= 8
    for step in res["steps"]:
        assert step["loss_rel_diff"] <= 1e-6, step
        assert step["mlp_grad_entries_differing"] == 0, step
        assert step["table_grad_in_row_gate"], step


@pytest.mark.cuda
def test_nccl_world1_graphed_global_culled_block_equals_eager(cuda_device):
    """One NCCL rank with the flagship's global culling (slice 11;
    GRAPH_FLAGSHIP: bf16 MLP operands, block 8, the schedule at 0.125 from
    step 8): a captured 16-step block, whose replays run the culling's
    all-gather and reduce-scatter, leaves the state of its 16 eager steps
    within the atomics' row gate, at the same budgets, and a replayed step
    runs the collectives of an eager one (2 of each: coarse and fine)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_ranks as ranks
    from hashnerf_torch.parallel.mesh import launch

    res = launch(ranks.card_graphed_global_rank, 1, "cuda", (GRAPH_FLAGSHIP,))[0]
    assert res["backend"] == "nccl" and res["keeps"] == [(0.125, 0.375)] * 3, res
    assert res["in_row_gate"] and all(np.isfinite(res["losses"])), res
    per = res["per_replayed_step"]
    assert per["all_gather"] == per["reduce_scatter"] == 2 and per["all_reduce"] >= 1, res


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [(0, 4), (4, 8), (6, 8)])
def test_level_shard_encode_on_card_matches_plain(cuda_device, levels):
    """K2 and K6 on one model rank's levels of a table (the level-sharded
    table's encode: its levels and their slice of the resolutions)."""
    table, x, probe, bmin, bmax, cfg = encode_inputs(7, 8, 12, 16, 512, 4001, -1.6, 1.6)
    dev = cuda_device
    lo, hi = levels
    local = torch.from_numpy(table[lo:hi]).to(dev).contiguous()
    res = cfg.resolutions_tensor(dev)[lo:hi].contiguous()
    args = [torch.from_numpy(a).to(dev) for a in (x, bmin, bmax)] + [res]
    g = torch.from_numpy(probe.reshape(len(x), 8, -1)[:, lo:hi].reshape(len(x), -1)).to(dev)
    g = g.contiguous()
    f, k = he.hash_encode_fwd(local, *args)
    fp, kp = he.hash_encode_fwd_plain(local, *args)
    assert f.shape == (len(x), (hi - lo) * local.shape[2]) and torch.equal(k, kp)
    torch.testing.assert_close(f, fp, rtol=1e-5, atol=1e-7)
    T = local.shape[1]
    got = he.hash_encode_bwd(*args, g, T)
    torch.cuda.synchronize()
    plain = he.hash_encode_bwd_plain(*args, g, T)
    abs_sum = he.hash_encode_bwd_plain(*args, g.abs(), T)
    assert got.shape == local.shape
    assert bool(((got - plain).abs() <= 2e-5 * abs_sum + 1e-6).all())

