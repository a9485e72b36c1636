"""The port's packed layout against the JAX package on the CPU: the wide-row
segment-sum (K4's plain version) and take_rows against the Pallas kernel in
interpret mode, PackedGridConfig and build_packed_dense, packed_encode
forward and backward, the packed TV, ray_aabb_near_far and the bf16 MLPs.

Geometry of tests/test_packed_train.py: L = 4, log2 T = 13, log2_blocks = 10,
finest 32, so level 0 is dense and levels 1-3 are block-hashed; F = 2, and
F = 8 for slabs 216 floats wide.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.kernels.segment_scatter import _sorted_segment_accumulate_tpu
from hashnerf_tpu.ops import packed_grid as jpg
from hashnerf_torch.kernels.gather import take_rows
from hashnerf_torch.kernels.segment_accum import sorted_segment_accumulate
from hashnerf_torch.ops import packed_grid as tpg

LO, HI = -1.5, 1.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(F, mod):
    return mod.PackedGridConfig(n_levels=4, n_features_per_level=F, log2_hashmap_size=13,
                                base_resolution=16, finest_resolution=32, log2_blocks=10)


def _tables(cfg, seed):
    """Normal tables (not the 1e-4 init, so that the sums are not tiny)."""
    rng = np.random.default_rng(seed)
    F = cfg.n_features_per_level
    return {
        "dense": rng.normal(size=(cfg.dense_offsets[-1], F)).astype(np.float32),
        "fine": rng.normal(size=(len(cfg.fine_resolutions) * cfg.n_block_rows, 27 * F)).astype(np.float32),
    }


def _points(cfg, n, seed):
    """Points in the bbox grown by 20%, a tenth of them snapped onto the
    vertices of a random level (float32, in the encoder's arithmetic), and
    the 8 bbox corners."""
    rng = np.random.default_rng(seed)
    ext = HI - LO
    x = rng.uniform(LO - 0.2 * ext, HI + 0.2 * ext, (n, 3)).astype(np.float32)
    res = np.asarray(cfg.resolutions, np.float32)[rng.integers(0, cfg.n_levels, n)]
    grid = np.float32(ext) / res
    k = np.floor(rng.uniform(0, 1, (n, 3)) * (res[:, None] + 1)).astype(np.float32)
    snap = rng.random(n) < 0.1
    x[snap] = (k * grid[:, None] + np.float32(LO)).astype(np.float32)[snap]
    corners = np.array([[a, b, c] for a in (LO, HI) for b in (LO, HI) for c in (LO, HI)], np.float32)
    return np.concatenate([x, corners])


BMIN = np.full(3, LO, np.float32)
BMAX = np.full(3, HI, np.float32)


# --------------------------------------------------------------------------- #
# K4's plain version and take_rows at the packed widths
# --------------------------------------------------------------------------- #

WIDE_F = [8, 16, 54, 64, 108, 216]


def _wide_case(F):
    rng = np.random.default_rng(F)
    idx = rng.integers(0, 2048, 3000).astype(np.int32)
    idx[:200] = 77  # one hot row
    return idx, rng.normal(size=(3000, F)).astype(np.float32), 2048


@pytest.mark.parametrize("F", WIDE_F)
def test_wide_segment_sum_matches_pallas_interpret(F):
    idx, vals, T = _wide_case(F)
    want = np.asarray(_sorted_segment_accumulate_tpu(jnp.asarray(idx), jnp.asarray(vals), num_rows=T))
    got = sorted_segment_accumulate(_t(idx), _t(vals), T).numpy()
    # float32 sums of the same terms in another order
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("F", WIDE_F)
def test_wide_take_rows_matches_pallas_interpret(F):
    idx, cot, T = _wide_case(F)
    table = np.random.default_rng(1).normal(size=(T, F)).astype(np.float32)
    tt = _t(table).requires_grad_(True)
    out = take_rows(tt, _t(idx).reshape(30, 100))
    (out * _t(cot).reshape(30, 100, F)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy().reshape(-1, F), table[idx])
    want = np.asarray(_sorted_segment_accumulate_tpu(jnp.asarray(idx), jnp.asarray(cot), num_rows=T))
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# Config and the dense rebuild
# --------------------------------------------------------------------------- #

SIZE_FIELDS = ("out_dim", "resolutions", "dense_level_count", "dense_resolutions",
               "fine_resolutions", "n_block_rows", "dense_vertex_counts", "dense_offsets",
               "packed_voxel_counts", "packed_offsets")


@pytest.mark.parametrize("kw", [
    dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13, finest_resolution=32,
         log2_blocks=10),
    dict(n_levels=4, n_features_per_level=8, log2_hashmap_size=19, finest_resolution=512,
         log2_blocks=16),  # the flagship of the packed slice
    dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19, finest_resolution=512,
         log2_blocks=16),
])
def test_packed_config_sizes_match_jax(kw):
    j, t = jpg.PackedGridConfig(**kw), tpg.PackedGridConfig(**kw)
    for f in SIZE_FIELDS:
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("F", [2, 8])
def test_build_packed_dense_matches_jax(F):
    jc, tc = _cfgs(F, jpg), _cfgs(F, tpg)
    dense = _tables(tc, 0)["dense"]
    want = np.asarray(jpg.build_packed_dense(jnp.asarray(dense), jc))
    np.testing.assert_array_equal(tpg.build_packed_dense(_t(dense), tc).numpy(), want)


def test_init_packed_tables_shapes_and_range():
    tc = _cfgs(8, tpg)
    gen = torch.Generator().manual_seed(0)
    tables = tpg.init_packed_tables(tc, gen)
    jt = jpg.init_packed_tables(jax.random.PRNGKey(0), _cfgs(8, jpg))
    assert {k: tuple(v.shape) for k, v in tables.items()} == {k: v.shape for k, v in jt.items()}
    for v in tables.values():
        assert float(v.abs().max()) <= 1e-4 and float(v.std()) > 1e-5


# --------------------------------------------------------------------------- #
# packed_encode
# --------------------------------------------------------------------------- #

def _jax_rows(x, jc):
    """The row ids JAX's packed_encode gathers, in its own arithmetic."""
    from hashnerf_tpu.ops.hashing import spatial_hash

    x = jnp.asarray(x)
    xc = jnp.clip(x, BMIN, BMAX)
    dense, fine = [], []
    for li, res in enumerate(jc.resolutions):
        grid = (BMAX - BMIN) / np.float32(res)
        rel = (xc - BMIN) / grid
        b = jnp.clip(jnp.floor(rel).astype(jnp.int32), 0, res - 1)
        if li < jc.dense_level_count:
            dense.append((b[:, 0] * res + b[:, 1]) * res + b[:, 2] + jc.packed_offsets[li])
        else:
            lf = li - jc.dense_level_count
            fine.append(spatial_hash(b >> 1, jc.log2_blocks) + lf * jc.n_block_rows)
    return np.asarray(jnp.concatenate(dense)), np.asarray(jnp.concatenate(fine))


@pytest.mark.parametrize("F", [2, 8])
def test_packed_encode_forward_matches_jax(F):
    jc, tc = _cfgs(F, jpg), _cfgs(F, tpg)
    tables = _tables(tc, 1)
    x = _points(tc, 1500, 2)
    fj, kj = jpg.packed_encode({k: jnp.asarray(v) for k, v in tables.items()},
                               jnp.asarray(x), jnp.asarray(BMIN), jnp.asarray(BMAX), jc)
    ft, kt = tpg.packed_encode({k: _t(v) for k, v in tables.items()}, _t(x), _t(BMIN), _t(BMAX), tc)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert not kt.numpy().all() and kt.numpy().any()
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-6)

    geo = tpg.packed_geometry(_t(x), _t(BMIN), _t(BMAX), tc)
    dense_j, fine_j = _jax_rows(x, jc)
    np.testing.assert_array_equal(geo.dense_rows.numpy(), dense_j)
    np.testing.assert_array_equal(geo.fine_rows.numpy(), fine_j)


@pytest.mark.parametrize("F", [2, 8])
def test_packed_encode_backward_matches_jax(F):
    jc, tc = _cfgs(F, jpg), _cfgs(F, tpg)
    tables = _tables(tc, 3)
    x = _points(tc, 1200, 4)
    probe = np.random.default_rng(5).normal(size=(x.shape[0], tc.out_dim)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(BMIN), jnp.asarray(BMAX))
    gj = jax.grad(lambda t: jnp.sum(jpg.packed_encode(t, *jargs, jc)[0] * probe))(
        {k: jnp.asarray(v) for k, v in tables.items()})

    tt = {k: _t(v).requires_grad_(True) for k, v in tables.items()}
    ft, _ = tpg.packed_encode(tt, _t(x), _t(BMIN), _t(BMAX), tc)
    (ft * _t(probe)).sum().backward()
    for k in ("dense", "fine"):
        assert float(tt[k].grad.abs().max()) > 0
        # the same products summed in other orders (8 shifted adds, K4's plain version)
        np.testing.assert_allclose(tt[k].grad.numpy(), np.asarray(gj[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# --------------------------------------------------------------------------- #
# The packed TV
# --------------------------------------------------------------------------- #

def jax_packed_tv_draws(key, jc):
    """The draws JAX's total_variation_loss_packed takes from `key`:
    (dense cuboid corners (Ld, 3), fine rows (Lf, k_rows), level-local)."""
    from hashnerf_tpu.train.losses import _tv_level_geometry

    keys = jax.random.split(key, jc.n_levels)
    corners = []
    for li, res in enumerate(jc.dense_resolutions):
        _, cube = _tv_level_geometry(jc.base_resolution, jc.finest_resolution, li, jc.n_levels)
        corners.append(np.asarray(jax.random.randint(keys[li], (3,), 0, max(res - min(cube, res), 1))))
    n_dense, n_fine = len(jc.dense_resolutions), len(jc.fine_resolutions)
    k_rows = max(4096 // n_fine, 512)
    rows = [np.asarray(jax.random.randint(keys[n_dense + fi], (k_rows,), 0, jc.n_block_rows))
            for fi in range(n_fine)]
    return np.stack(corners), np.stack(rows)


@pytest.mark.parametrize("F", [2, 8])
def test_packed_tv_matches_jax(F):
    from hashnerf_tpu.train.losses import total_variation_loss_packed as jtv
    from hashnerf_torch.train.losses import total_variation_loss_packed

    jc, tc = _cfgs(F, jpg), _cfgs(F, tpg)
    tables = _tables(tc, 6)
    key = jax.random.PRNGKey(7)
    val_j, grad_j = jax.value_and_grad(lambda t: jtv(key, t, jc))(
        {k: jnp.asarray(v) for k, v in tables.items()})
    corners, rows = jax_packed_tv_draws(key, jc)

    tt = {k: _t(v).requires_grad_(True) for k, v in tables.items()}
    val = total_variation_loss_packed(tt, tc, _t(corners), _t(rows))
    val.backward()
    # sums of ~1e5 squared differences in another order
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-5)
    for k in ("dense", "fine"):
        np.testing.assert_allclose(tt[k].grad.numpy(), np.asarray(grad_j[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_packed_tv_draws_in_range():
    from hashnerf_torch.train.losses import draw_packed_tv

    tc = _cfgs(2, tpg)
    corners, rows = draw_packed_tv(tc, torch.Generator().manual_seed(0))
    assert corners.shape == (1, 3) and rows.shape == (3, 1365)
    assert int(rows.min()) >= 0 and int(rows.max()) < tc.n_block_rows
    assert int(corners.min()) >= 0 and int(corners.max()) < 16


# --------------------------------------------------------------------------- #
# ray_aabb_near_far
# --------------------------------------------------------------------------- #

def test_ray_aabb_near_far_matches_jax():
    from hashnerf_tpu.ops.rays import ray_aabb_near_far as jclip
    from hashnerf_torch.ops.rays import ray_aabb_near_far

    rng = np.random.default_rng(8)
    n = 400
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:300] += np.sign(o[:300]) * 1.5  # outside the box
    target = rng.uniform(LO, HI, (n, 3)).astype(np.float32)
    d = (target - o).astype(np.float32)
    # rays along an axis (|d| <= 1e-10 in two components), rays starting
    # inside the box, rays pointing away from it (misses)
    d[200:240, 1:] = 0.0
    d[240:260, :2] = np.float32(1e-12)
    o[260:300] = rng.uniform(-1, 1, (40, 3))
    o[300:] = rng.uniform(2, 4, (100, 3)) * np.sign(rng.normal(size=(100, 3)))
    d[300:] = o[300:]
    near = np.full(n, 0.5, np.float32)
    far = np.full(n, 9.0, np.float32)
    bbox = np.stack([BMIN, BMAX])
    nj, fj = jclip(*(jnp.asarray(a) for a in (o, d, bbox, near, far)))
    nt, ft = ray_aabb_near_far(*(_t(a) for a in (o, d, bbox, near, far)))
    miss = np.asarray(fj) == near + np.float32(1e-3)
    assert miss[300:].all() and not miss[:200].any() and miss[200:260].any()
    np.testing.assert_array_max_ulp(nt.numpy(), np.asarray(nj), maxulp=1)
    np.testing.assert_array_max_ulp(ft.numpy(), np.asarray(fj), maxulp=1)


# --------------------------------------------------------------------------- #
# bf16 MLPs
# --------------------------------------------------------------------------- #

def _mlp_params(rng, cfg):
    dims = [(cfg.input_ch, 64), (64, 16)], [(cfg.input_ch_views + 15, 64), (64, 64), (64, 3)]
    return {name: [{"w": (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)} for s in shapes]
            for name, shapes in zip(("sigma_net", "color_net"), dims)}


def test_nerf_small_bf16_matches_jax():
    from hashnerf_tpu.models.nerf import NeRFSmallConfig as JCfg, apply_nerf_small
    from hashnerf_torch.convert import _load_mlp
    from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig

    rng = np.random.default_rng(9)
    cfg = NeRFSmallConfig(input_ch=32, input_ch_views=16, compute_dtype="bfloat16")
    params = _mlp_params(rng, cfg)
    x = rng.normal(size=(500, 48)).astype(np.float32)
    probe = rng.normal(size=(500, 4)).astype(np.float32)
    jcfg = JCfg(input_ch=32, input_ch_views=16)
    f = lambda p, x_: jnp.sum(apply_nerf_small(p, x_, jcfg, jnp.bfloat16) * probe)
    yj = apply_nerf_small(params, jnp.asarray(x), jcfg, jnp.bfloat16)
    gp, gx = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))

    net = NeRFSmall(cfg)
    with torch.no_grad():
        _load_mlp(net, params)
    xt = _t(x).requires_grad_(True)
    yt = net(xt)
    (yt * _t(probe)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-2, atol=1e-4)
    for name in ("sigma_net", "color_net"):
        for layer, jl in zip(getattr(net, name), gp[name]):
            np.testing.assert_allclose(layer.weight.grad.numpy(), np.asarray(jl["w"]).T,
                                       rtol=2e-2, atol=1e-4, err_msg=name)


def test_packed_query_fn_bf16_matches_jax():
    from hashnerf_tpu.models.factory import ModelConfig as JModelConfig, create_model
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JHash
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    kw = dict(n_levels=4, n_features_per_level=8, log2_hashmap_size=13, finest_resolution=32)
    common = dict(N_importance=8, share_fine=True, compute_dtype="bfloat16", packed_layout=True,
                  log2_blocks=10)
    jstate, jquery = create_model(jax.random.PRNGKey(0), JModelConfig(hash_grid=JHash(**kw), **common))
    assert jstate.fine is None
    tables = _tables(_cfgs(8, tpg), 10)  # not the 1e-4 init: features of size 1
    jstate = jstate._replace(hash_table={k: jnp.asarray(v) for k, v in tables.items()})
    state = NGPState(ModelConfig(hash_grid=HashGridConfig(**kw), **common), device="cpu")
    assert state.fine is None
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(state, tables, to_np(jstate.coarse), None)

    rng = np.random.default_rng(11)
    pts = _points(_cfgs(8, tpg), 392, 12).reshape(50, 8, 3)
    vd = rng.normal(size=(50, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    probe = rng.normal(size=(50, 8, 4)).astype(np.float32)
    bbox = np.stack([BMIN, BMAX])
    jargs = (jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(bbox))
    rj = jquery(jstate, *jargs, fine=True)
    gj = jax.grad(lambda s: jnp.sum(jquery(s, *jargs, fine=True) * probe))(jstate)

    rt = query_fn(state, _t(pts), _t(vd), _t(bbox), fine=True)
    (rt * _t(probe)).sum().backward()
    np.testing.assert_allclose(rt.detach().numpy(), np.asarray(rj), rtol=2e-3, atol=1e-4)
    for k in ("dense", "fine"):
        np.testing.assert_allclose(state.hash_table[k].grad.numpy(), np.asarray(gj.hash_table[k]),
                                   rtol=2e-2, atol=1e-4, err_msg=k)
    for layer, jl in zip(state.coarse.sigma_net, gj.coarse["sigma_net"]):
        np.testing.assert_allclose(layer.weight.grad.numpy(), np.asarray(jl["w"]).T,
                                   rtol=2e-2, atol=1e-4)


@pytest.mark.parametrize("log2_blocks,want", [(-1, 10), (7, 7), (0, None), (-2, None)])
def test_log2_blocks_auto_and_refused(log2_blocks, want):
    """-1 is log2_hashmap_size - 3; an explicit 0 or other negative raises,
    as hashnerf_tpu/models/factory.py:83-88 does."""
    from hashnerf_torch.models.factory import ModelConfig
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    cfg = ModelConfig(hash_grid=HashGridConfig(n_levels=4, log2_hashmap_size=13, finest_resolution=32),
                      packed_layout=True, log2_blocks=log2_blocks)
    if want is None:
        with pytest.raises(ValueError, match="log2_blocks"):
            cfg.packed_grid
    else:
        assert cfg.packed_grid.log2_blocks == want
