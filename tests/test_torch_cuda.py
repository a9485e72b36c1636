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
    # a TV step: K2 and K6 in each pass, K5 for the TV loss
    assert graph.launches == {"hash_encode_fwd": 2, "hash_encode_bwd": 2, "segment_accumulate_k5": 1}
    reset_launch_counts()
    t.run_steps(16, block_size=16)  # replays only
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {k: 16 * v for k, v in graph.launches.items()}


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
