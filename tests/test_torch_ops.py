"""The port's pure ops (hashnerf_torch/ops) against the JAX package and the
reference goldens, on the CPU, with inputs made from a seed with numpy."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.ops import hashing as jhash
from hashnerf_tpu.ops import hash_encoding as jhe
from hashnerf_torch.ops import hashing as thash
from hashnerf_torch.ops import hash_encoding as the

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "reference_golden.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# hashing and grid geometry
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("log2_T", [12, 19, 24])
@pytest.mark.parametrize("d", [3, 7])
def test_spatial_hash_bit_identical(log2_T, d):
    rng = np.random.default_rng(log2_T + d)
    # grid coordinates up to finest_res + 1 (513), plus negatives and large
    # values that wrap in uint32
    c = np.concatenate([
        rng.integers(0, 514, (4000, d)),
        rng.integers(-600, 0, (500, d)),
        rng.integers(0, 2**31 - 1, (500, d)),
    ]).astype(np.int32)
    want = np.asarray(jhash.spatial_hash(jnp.asarray(c), log2_T))
    got = thash.spatial_hash(_t(c), log2_T).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(thash.BOX_OFFSETS, jhash.BOX_OFFSETS)
    assert thash.HASH_PRIMES == jhash.HASH_PRIMES


@pytest.mark.parametrize("base,finest,L", [(16, 512, 16), (16, 64, 16), (4, 32, 4), (16, 2048, 8)])
def test_level_resolutions_equal(base, finest, L):
    assert the.level_resolutions(base, finest, L) == jhe.level_resolutions(base, finest, L)


def test_corner_weights_match():
    w = np.random.default_rng(0).uniform(0, 1, (100, 3)).astype(np.float32)
    np.testing.assert_allclose(
        the.corner_weights(_t(w)).numpy(), np.asarray(jhe._corner_weights(jnp.asarray(w))),
        rtol=1e-6, atol=0,
    )


def _points(rng, n, cfg, lo=-1.0, hi=1.0):
    """Uniform points in the bbox grown by 20%, 10% snapped to grid vertices
    (in float32) so floor() meets cell boundaries."""
    x = rng.uniform(lo * 1.2, hi * 1.2, (n, 3)).astype(np.float32)
    res = np.asarray(cfg.resolutions, np.float32)
    lev = rng.integers(0, len(res), n)
    grid = (np.float32(hi) - np.float32(lo)) / res[lev]
    k = np.floor(rng.uniform(0, 1, (n, 3)) * res[lev][:, None]).astype(np.float32)
    snapped = (k * grid[:, None] + np.float32(lo)).astype(np.float32)
    m = rng.random(n) < 0.1
    x[m] = snapped[m]
    return x


def test_plain_hash_encode_matches_jax():
    cfg_j = jhe.HashGridConfig(n_levels=16, log2_hashmap_size=12)
    cfg_t = the.HashGridConfig(n_levels=16, log2_hashmap_size=12)
    rng = np.random.default_rng(1)
    table = rng.normal(size=(16, 4096, 2)).astype(np.float32)
    x = _points(rng, 512, cfg_t)
    bmin = np.full(3, -1.0, np.float32)
    bmax = np.full(3, 1.0, np.float32)
    jargs = (jnp.asarray(table), jnp.asarray(x), jnp.asarray(bmin), jnp.asarray(bmax), cfg_j)
    # Op by op, JAX rounds every operation on its own, as the port does.
    with jax.disable_jit():
        fj, kj = jhe.hash_encode(*jargs)
    ft, kt = the.hash_encode(_t(table), _t(x), _t(bmin), _t(bmax), cfg_t)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < kt.sum() < len(x)
    # same hashed corners and weights; the 8-term blend may sum in another order
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=1e-7)

    # Jitted on the CPU, XLA rewrites w = (xc - (bl*grid + bmin)) / grid in
    # the fused program, so its trilinear weights differ from the IEEE
    # op-by-op values by up to ~1 ulp of `rel` (6e-5 at resolution 512).
    # The port stays within float32 rounding of a float64 oracle instead.
    fjit, kjit = jhe.hash_encode(*jargs)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kjit))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fjit), rtol=0, atol=2e-4)
    idx, cw, _ = the.corner_geometry(_t(x), _t(bmin), _t(bmax),
                                     cfg_t.resolutions_tensor("cpu"), 12)
    emb = table[np.arange(16)[:, None, None], idx.numpy()].astype(np.float64)  # (L,N,8,F)
    ref = (cw.numpy().astype(np.float64)[..., None] * emb).sum(2).transpose(1, 0, 2)
    np.testing.assert_allclose(ft.numpy(), ref.reshape(len(x), -1), rtol=0, atol=1e-6)


def test_init_hash_table_range():
    cfg = the.HashGridConfig(n_levels=4, log2_hashmap_size=10)
    gen = torch.Generator().manual_seed(0)
    t = the.init_hash_table(cfg, gen)
    assert t.shape == (4, 1024, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 1e-5


# --------------------------------------------------------------------------- #
# SH, rays, volume, sampling against the JAX functions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_matches_jax(degree):
    from hashnerf_tpu.ops.sh_encoding import sh_encode as jsh
    from hashnerf_torch.ops.sh_encoding import sh_encode as tsh

    d = np.random.default_rng(degree).normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(tsh(_t(d), degree).numpy(), np.asarray(jsh(jnp.asarray(d), degree)),
                               rtol=1e-6, atol=1e-7)


def test_get_rays_matches_jax():
    from hashnerf_tpu.ops import rays as jr
    from hashnerf_torch.ops import rays as tr

    rng = np.random.default_rng(2)
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
    c2w = rng.normal(size=(3, 4)).astype(np.float32)
    jo, jd = jr.get_rays(24, 32, K, c2w)
    to, td = tr.get_rays(24, 32, K, _t(c2w))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    # three-term float32 sums in another order
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    no, nd = tr.get_rays_np(24, 32, K, c2w)
    wo, wd = jr.get_rays_np(24, 32, K, c2w)
    np.testing.assert_array_equal(no, wo)
    np.testing.assert_array_equal(nd, wd)


@pytest.mark.parametrize("wb,noise", [(False, 0.0), (True, 0.0), (True, 1.0)])
def test_raw2outputs_matches_jax(wb, noise):
    from hashnerf_tpu.ops.volume import raw2outputs as jr2o
    from hashnerf_torch.ops.volume import raw2outputs as tr2o

    rng = np.random.default_rng(3)
    raw = rng.normal(size=(16, 24, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (16, 24)), -1).astype(np.float32)
    rd = rng.normal(size=(16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jr2o(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd), noise, wb, noise_key=key)
    draw = np.asarray(jax.random.normal(key, (16, 24)))  # the JAX noise draw
    got = tr2o(_t(raw), _t(z), _t(rd), noise, wb, noise=_t(draw))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_and_perturb_match_jax(lindisp):
    from hashnerf_tpu.ops import sampling as js
    from hashnerf_torch.ops import sampling as ts

    rng = np.random.default_rng(4)
    near = rng.uniform(1, 2, 32).astype(np.float32)
    far = rng.uniform(4, 6, 32).astype(np.float32)
    zj = js.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 64, lindisp)
    zt = ts.stratified_z_vals(_t(near), _t(far), 64, lindisp)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6, atol=1e-6)

    key = jax.random.PRNGKey(1)
    pj = js.perturb_z_vals(key, zj)
    t_rand = np.asarray(jax.random.uniform(key, zj.shape))
    pt = ts.perturb_z_vals(zt, _t(t_rand))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    from hashnerf_tpu.ops.sampling import sample_pdf as jpdf
    from hashnerf_torch.ops.sampling import sample_pdf as tpdf

    rng = np.random.default_rng(5)
    bins = np.sort(rng.uniform(2, 6, (32, 63)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (32, 62)).astype(np.float32)
    w[:, :20] = 0.0  # empty stretch: denominators below 1e-5
    key = jax.random.PRNGKey(3)
    want = jpdf(key, jnp.asarray(bins), jnp.asarray(w), 128, det=det)
    u = None if det else _t(np.asarray(jax.random.uniform(key, (32, 128))))
    got = tpdf(_t(bins), _t(w), 128, det=det, u=u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# reference goldens (tests/test_golden_reference.py), re-run on the port
# --------------------------------------------------------------------------- #

HCFG = the.HashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=12,
                          base_resolution=16, finest_resolution=512)


def _inside(g):
    pts, bmin, bmax = g["hash_pts"], g["hash_bbox_min"], g["hash_bbox_max"]
    return np.all((pts >= bmin) & (pts <= bmax), axis=-1)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_golden_hash_forward(g, impl):
    args = (_t(g["hash_table"]), _t(g["hash_pts"]), _t(g["hash_bbox_min"]), _t(g["hash_bbox_max"]))
    if impl == "plain":
        feats, keep = the.hash_encode(*args, HCFG)
    else:
        from hashnerf_torch.kernels.hash_encode import hash_encode

        feats, keep = hash_encode(*args, HCFG.resolutions_tensor("cpu"))
    inside = _inside(g)
    assert 0 < inside.sum() < len(inside)
    np.testing.assert_allclose(feats.numpy()[inside], g["hash_feats"][inside], rtol=1e-4, atol=1e-8)
    # the honest keep mask (the reference's recorded mask is all-True)
    np.testing.assert_array_equal(keep.numpy(), inside)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_golden_hash_table_gradient(g, impl):
    table = _t(g["hash_table"]).clone().requires_grad_(True)
    args = (_t(g["hash_pts"]), _t(g["hash_bbox_min"]), _t(g["hash_bbox_max"]))
    if impl == "plain":
        feats, _ = the.hash_encode(table, *args, HCFG)
    else:
        from hashnerf_torch.kernels.hash_encode import hash_encode

        feats, _ = hash_encode(table, *args, HCFG.resolutions_tensor("cpu"))
    (feats * _t(g["hash_probe"])).sum().backward()
    np.testing.assert_allclose(table.grad.numpy(), g["hash_table_grad"], rtol=5e-3, atol=1e-5)


def test_golden_sh(g):
    from hashnerf_torch.ops.sh_encoding import sh_encode

    np.testing.assert_allclose(sh_encode(_t(g["sh_in"]), 4).numpy(), g["sh_out"],
                               rtol=1e-5, atol=1e-6)


def test_golden_sample_pdf(g):
    from hashnerf_torch.ops.sampling import sample_pdf

    out = sample_pdf(_t(g["pdf_bins"]), _t(g["pdf_weights"]), 128, u=_t(g["pdf_u"]))
    np.testing.assert_allclose(out.numpy(), g["pdf_samples"], rtol=1e-4, atol=1e-5)
    det = sample_pdf(_t(g["pdf_bins"]), _t(g["pdf_weights"]), 128, det=True)
    np.testing.assert_allclose(det.numpy(), g["pdf_samples_det"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wb", [False, True])
def test_golden_raw2outputs(g, wb):
    from hashnerf_torch.ops.volume import raw2outputs

    out = raw2outputs(_t(g["r2o_raw"]), _t(g["r2o_z"]), _t(g["r2o_raysd"]),
                      raw_noise_std=0.0, white_bkgd=wb)
    tag = "_wb" if wb else ""
    np.testing.assert_allclose(out.rgb_map.numpy(), g[f"r2o_rgb{tag}"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.disp_map.numpy(), g[f"r2o_disp{tag}"], rtol=1e-4)
    np.testing.assert_allclose(out.acc_map.numpy(), g[f"r2o_acc{tag}"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.weights.numpy(), g[f"r2o_weights{tag}"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(out.depth_map.numpy(), g[f"r2o_depth{tag}"], rtol=1e-4)
    np.testing.assert_allclose(out.sparsity_loss.numpy(), g[f"r2o_sparsity{tag}"], rtol=1e-4)


def test_golden_get_rays(g):
    from hashnerf_torch.ops.rays import get_rays

    H, W = int(g["rays_hwf"][0]), int(g["rays_hwf"][1])
    ro, rd = get_rays(H, W, _t(g["rays_K"]), _t(g["rays_c2w"]))
    np.testing.assert_allclose(ro.numpy(), g["rays_o"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), g["rays_d"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 8, 64, 128, 192])
def test_linspace01_matches_jnp_linspace(n):
    """The port's t values equal jnp.linspace(0, 1, n) as the JAX package
    computes it op by op; torch.linspace rounds some of them otherwise."""
    from hashnerf_torch.ops.sampling import linspace01

    with jax.disable_jit():
        want = np.asarray(jnp.linspace(0.0, 1.0, n))
    np.testing.assert_array_equal(linspace01(n).numpy(), want)
    if n in (8, 64):
        assert (torch.linspace(0.0, 1.0, n).numpy() != want).any()
