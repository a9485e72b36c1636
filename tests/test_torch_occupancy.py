"""The port's occupancy culling and fast_merge against the JAX package on
the CPU: permute_rows, every function of render/occupancy.py, raw2outputs'
`dists=`, sorted_uniform and merge_sorted, each on inputs made from a seed
with numpy (query_with_culling and render_rays are in
test_torch_occupancy_render.py).

The inputs are full of ties, as culling's are: points outside the bbox all
score -1, the grids take a few values only (many cells share each), and
blocks share cells. The kept sets must be identical: integer outputs are
compared exactly, float outputs at rtol 1e-6 (the grid update) or exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.render import occupancy as jocc
from hashnerf_torch.render import occupancy as tocc

LO, HI = -1.5, 1.5
BBOX = np.array([[LO] * 3, [HI] * 3], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    return jocc.OccupancyConfig(**kw), tocc.OccupancyConfig(**kw)


def tie_grid(R, seed, occupied=0.2):
    """(R^3,) float32: a ball of cells with values from {0.5, 1, 2}, zeros
    elsewhere and on a fifth of the ball."""
    rng = np.random.default_rng(seed)
    c = (np.arange(R) + 0.5) / R * 2 - 1
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    ball = (x**2 + y**2 + (z - 0.2) ** 2) < 0.6**2
    vals = rng.choice(np.float32([0.5, 1.0, 2.0]), R**3)
    vals[rng.random(R**3) < occupied] = 0.0
    return np.where(ball.reshape(-1), vals, 0.0).astype(np.float32)


def ray_batch(n_rays, seed):
    """Rays from a sphere of radius 4 through the middle of the bbox."""
    rng = np.random.default_rng(seed)
    target = rng.uniform(-0.8, 0.8, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = target - 4.0 * d
    return o.astype(np.float32), (target - o).astype(np.float32) / 4.0


def ray_pts(n_rays, S, seed):
    """(n_rays, S, 3) points along rays at sorted depths in [2, 6] (about a
    third outside the bbox), a tenth snapped onto cell boundaries of a
    32^3 grid."""
    rng = np.random.default_rng(seed)
    o, d = ray_batch(n_rays, seed)
    t = np.sort(rng.uniform(2.0, 6.0, (n_rays, S)), axis=1)
    p = (o[:, None] + t[..., None] * d[:, None]).astype(np.float32)
    snap = rng.random((n_rays, S)) < 0.1
    cell = np.float32(HI - LO) / np.float32(32)
    p_snap = (np.round((p - LO) / cell) * cell + LO).astype(np.float32)
    return np.where(snap[..., None], p_snap, p)


# --------------------------------------------------------------------------- #
# permute_rows
# --------------------------------------------------------------------------- #

def test_permute_rows_matches_jax():
    """tests/test_kernels.py's permute_rows case: forward x[perm], backward
    the gather by the inverse permutation."""
    from hashnerf_tpu.kernels.gather_vjp import permute_rows as jpermute
    from hashnerf_torch.kernels.gather import permute_rows

    rng = np.random.default_rng(3)
    N, C = 257, 4
    x = rng.normal(size=(N, C)).astype(np.float32)
    perm = rng.permutation(N).astype(np.int32)
    inv = np.argsort(perm).astype(np.int32)
    cot = rng.normal(size=(N, C)).astype(np.float32)
    jargs = (jnp.asarray(perm), jnp.asarray(inv))
    gj = jax.grad(lambda x_: jnp.vdot(jpermute(x_, *jargs), jnp.asarray(cot)))(jnp.asarray(x))

    xt = _t(x).requires_grad_(True)
    out = permute_rows(xt, _t(perm).long(), _t(inv).long())
    (out * _t(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jpermute(jnp.asarray(x), *jargs)))
    # a permutation moves each value once: the gradient is exact
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))


# --------------------------------------------------------------------------- #
# Grid lookups
# --------------------------------------------------------------------------- #

def test_cell_index_scores_and_lookup_match_jax():
    jc, tc = _cfgs(resolution=32)
    grid = tie_grid(32, 0)
    pts = ray_pts(64, 48, 1).reshape(-1, 3)
    pts[:20] = BBOX[0]  # the bbox corners: cells 0 and R^3 - 1
    pts[20:40] = BBOX[1]
    jargs = (jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(BBOX), jc)
    targs = (_t(grid), _t(pts), _t(BBOX), tc)
    idx_j = np.asarray(jocc._cell_index(jnp.asarray(pts), jnp.asarray(BBOX), 32))
    np.testing.assert_array_equal(tocc.cell_index(_t(pts), _t(BBOX), 32).numpy(), idx_j)
    s_j = np.asarray(jocc.occupancy_scores(*jargs))
    s_t = tocc.occupancy_scores(*targs).numpy()
    np.testing.assert_array_equal(s_t, s_j)
    assert (s_j == -1).sum() > 500 and (s_j == 1.0).sum() > 100 and (s_j == 0).sum() > 100
    # threshold min(1e-2, mean) and min(0.6, mean) (= the mean here)
    for thr in (1e-2, 0.6):
        jc2, tc2 = _cfgs(resolution=32, threshold=thr)
        np.testing.assert_array_equal(
            tocc.occupancy_lookup(*targs[:3], tc2).numpy(),
            np.asarray(jocc.occupancy_lookup(*jargs[:3], jc2)))


@pytest.mark.parametrize("R", [8, 32])
def test_dilate_grid_matches_jax(R):
    grid = tie_grid(R, R)
    want = np.asarray(jocc.dilate_grid(jnp.asarray(grid), R))
    np.testing.assert_array_equal(tocc.dilate_grid(_t(grid), R).numpy(), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_strided_scores_match_jax(stride):
    jc, tc = _cfgs(resolution=32, score_stride=stride)
    grid = tie_grid(32, 2)
    pts = ray_pts(32, 47, 3)  # an odd S: the repeat is cut
    gd_j = jocc.dilate_grid(jnp.asarray(grid), 32)
    want = np.asarray(jocc.occupancy_scores_strided(gd_j, jnp.asarray(pts), jnp.asarray(BBOX), jc))
    got = tocc.occupancy_scores_strided(tocc.dilate_grid(_t(grid), 32), _t(pts), _t(BBOX), tc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_score_stride_above_two_is_refused():
    tocc.OccupancyConfig(score_stride=2)
    with pytest.raises(ValueError, match="two cells apart"):
        tocc.OccupancyConfig(score_stride=3)


def test_per_ray_select_is_validated():
    for select in ("sort", "topk", "approx"):
        tocc.OccupancyConfig(per_ray_select=select)
    with pytest.raises(ValueError, match="per_ray_select"):
        tocc.OccupancyConfig(per_ray_select="heap")


# --------------------------------------------------------------------------- #
# Grid updates
# --------------------------------------------------------------------------- #

def jax_cell_draws(grid, k_cell, cfg):
    """The draws JAX's sample_update_cells takes from `k_cell`."""
    n, R = cfg.n_update_samples, cfg.resolution
    if not cfg.adaptive_update or R % 32:
        return tocc.OccUpdateDraws(uniform_cells=_t(jax.random.randint(k_cell, (n,), 0, cfg.n_cells)))
    k_u, k_blk, k_off = jax.random.split(k_cell, 3)
    n_half, S = n // 2, R // 32
    blocks = jnp.asarray(grid).reshape(32, S, 32, S, 32, S).max(axis=(1, 3, 5)).reshape(-1)
    top_val, _ = jax.lax.top_k(blocks, 1024)
    logits = jnp.log(jnp.maximum(top_val, 0.0) + 1e-8)
    return tocc.OccUpdateDraws(
        uniform_cells=_t(jax.random.randint(k_u, (n - n_half,), 0, cfg.n_cells)),
        block_sel=_t(jax.random.categorical(k_blk, logits, shape=(n_half,))),
        offsets=_t(jax.random.randint(k_off, (n_half, 3), -1, S + 1)),
    )


def jax_update_draws(grid, key, cfg):
    """The draws of one grid update from `key`: the cells' and the jitter."""
    k_cell, k_jit = jax.random.split(key)
    return jax_cell_draws(grid, k_cell, cfg)._replace(
        jitter=_t(jax.random.uniform(k_jit, (cfg.n_update_samples, 3))))


# R = 32: one cell a macro-block; R = 64: 2^3 cells a block, offsets -1..2.
# The grids have far fewer than 1024 occupied blocks, so the top blocks end
# in a run of ties at 0.
@pytest.mark.parametrize("R,adaptive", [(32, True), (64, True), (32, False), (24, True)])
def test_sample_update_cells_matches_jax(R, adaptive):
    jc, tc = _cfgs(resolution=R, adaptive_update=adaptive, n_update_samples=4096)
    grid = tie_grid(R, R, occupied=0.97)
    key = jax.random.PRNGKey(R)
    want = np.asarray(jocc.sample_update_cells(jnp.asarray(grid), key, jc))
    got = tocc.sample_update_cells(_t(grid), tc, jax_cell_draws(grid, key, jc))
    np.testing.assert_array_equal(got.numpy(), want)


def _sigma_j(p):
    return 2.0 - 3.0 * (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2]


def _sigma_t(p):
    return 2.0 - 3.0 * (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2]


@pytest.mark.parametrize("R,adaptive", [(32, True), (24, False)])
def test_update_occupancy_grid_matches_jax(R, adaptive):
    """The decay, the jittered points, relu and the max at repeated cells;
    R = 24 divides by a number that is not a power of two."""
    jc, tc = _cfgs(resolution=R, adaptive_update=adaptive, n_update_samples=8192)
    grid = tie_grid(R, 5)
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        want = np.asarray(jocc.update_occupancy_grid(jnp.asarray(grid), key, jnp.asarray(BBOX),
                                                     jc, _sigma_j))
    got = tocc.update_occupancy_grid(_t(grid), _t(BBOX), tc, _sigma_t,
                                     jax_update_draws(grid, key, jc)).numpy()
    assert (got != grid * np.float32(0.95)).sum() > 1000  # the max wrote
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------- #
# Selection
# --------------------------------------------------------------------------- #

def tie_scores(shape, seed):
    """Scores from {-1, 0, 0.5, 1, 2}: long runs of equal values."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.float32([-1.0, 0.0, 0.5, 1.0, 2.0]), shape, p=[0.3, 0.3, 0.2, 0.1, 0.1])


@pytest.mark.parametrize("select", ["sort", "topk", "approx"])
@pytest.mark.parametrize("K", [8, 24])
def test_cull_per_ray_matches_jax(select, K):
    s = tie_scores((40, 48), 11)
    """JAX under each selection gives the port's one stable selection."""
    want = np.asarray(jocc.cull_per_ray(jnp.asarray(s), K, select=select))
    got = tocc.cull_per_ray(_t(s), K)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_invert_permutation_matches_jax():
    order = np.random.default_rng(4).permutation(1000)
    want = np.asarray(jocc._invert_permutation(jnp.asarray(order, jnp.int32)))
    np.testing.assert_array_equal(tocc._invert_permutation(_t(order)).numpy(), want)


@pytest.mark.parametrize("mode", ["sort1", "sort2", "cumsum"])
@pytest.mark.parametrize("keep_k", [128, 300, 1000])
def test_cull_points_matches_jax(mode, keep_k):
    s = tie_scores((2000,), keep_k)
    s[::7] += np.float32(0.25)  # more levels for the cumsum edges
    kj, oj, ij = (np.asarray(a) for a in jocc.cull_points(jnp.asarray(s), keep_k, mode=mode))
    kt, ot, it = tocc.cull_points(_t(s), keep_k, mode=mode)
    np.testing.assert_array_equal(kt.numpy(), kj)
    np.testing.assert_array_equal(ot.numpy(), oj)
    np.testing.assert_array_equal(it.numpy(), ij)


@pytest.mark.parametrize("mode", ["sort1", "sort2"])
def test_cull_points_bool_matches_jax(mode):
    occ = np.random.default_rng(12).random(999) < 0.3
    for a, b in zip(tocc.cull_points(_t(occ), 256, mode=mode),
                    jocc.cull_points(jnp.asarray(occ), 256, mode=mode)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cull_points_cumsum_edge_cases_match_jax():
    """All scores equal (no edge fits) and a budget that takes everything."""
    for s, k in ((np.full(500, 0.5, np.float32), 128), (tie_scores((500,), 1), 500)):
        for a, b in zip(tocc.cull_points_cumsum(_t(s), k), jocc.cull_points_cumsum(jnp.asarray(s), k)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------------------- #
# Samplers and the compositor
# --------------------------------------------------------------------------- #

def test_sorted_uniform_law():
    """Sorted rows whose values are, as a multiset, iid U(0, 1): the
    Kolmogorov-Smirnov distance of 40,000 values stays under 1.63 / sqrt(n)
    (the 1% level), and the k-th of n has mean k / (n + 1)."""
    from hashnerf_torch.ops.sampling import sorted_uniform

    g = torch.Generator().manual_seed(0)
    u = sorted_uniform((5000, 8), g)
    assert u.shape == (5000, 8) and bool((u[:, 1:] >= u[:, :-1]).all())
    assert float(u.min()) > 0 and float(u.max()) < 1
    x = np.sort(u.numpy().reshape(-1))
    n = x.size
    ecdf_hi = np.arange(1, n + 1) / n
    d = max(np.max(ecdf_hi - x), np.max(x - (ecdf_hi - 1 / n)))
    assert d < 1.63 / np.sqrt(n), d
    # k-th order statistic of 8: mean k / 9, sd below 0.16 -> 5000 rows, 5 se
    np.testing.assert_allclose(u.numpy().mean(0), np.arange(1, 9) / 9, atol=5 * 0.16 / np.sqrt(5000))


def test_merge_sorted_matches_jnp_sort():
    from hashnerf_tpu.ops.sampling import merge_sorted as jmerge
    from hashnerf_torch.ops.sampling import merge_sorted

    rng = np.random.default_rng(13)
    a = np.sort(rng.uniform(2, 6, (50, 16)).astype(np.float32), axis=1)
    b = np.sort(rng.uniform(2, 6, (50, 24)).astype(np.float32), axis=1)
    b[:5, :3] = 1.0  # before all of a
    b[5:10, -3:] = 7.0  # after all of a
    want = np.asarray(jnp.sort(jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], -1), axis=-1))
    got = merge_sorted(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jmerge(jnp.asarray(a), jnp.asarray(b))))
    # equal values across the rows: JAX puts a's first, which values cannot show
    a2, b2 = np.float32([[1, 2, 3]]), np.float32([[2, 3, 4]])
    np.testing.assert_array_equal(merge_sorted(_t(a2), _t(b2)).numpy(), [[1, 2, 2, 3, 3, 4]])


def test_raw2outputs_dists_override_matches_jax():
    from hashnerf_tpu.ops.volume import raw2outputs as jr2o
    from hashnerf_torch.ops.volume import raw2outputs

    rng = np.random.default_rng(14)
    raw = rng.normal(size=(30, 12, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (30, 12)).astype(np.float32), axis=1)
    dists = rng.uniform(0.01, 0.3, (30, 12)).astype(np.float32)
    rd = rng.normal(size=(30, 3)).astype(np.float32)
    want = jr2o(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd), white_bkgd=True,
                dists=jnp.asarray(dists))
    got = raw2outputs(_t(raw), _t(z), _t(rd), white_bkgd=True, dists=_t(dists))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
