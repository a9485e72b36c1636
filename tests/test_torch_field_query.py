"""The field query's per-ray view encoding, K9's colour input and field_raw
(kernels/field_query.py) on the CPU, against the per-sample composition
they replaced, kept here as the plain reference: the directions expanded to
every sample, encoded on N rows and concatenated to the features; NeRFSmall
slicing them back out and concatenating [views, geo features] and [rgb,
sigma]; the keep mask by where and cat.

The values the colour net reads are copies, so the view encoding and the
colour input equal the reference's bit for bit. Raw and every leaf's
gradient are held at float32 rounding (rtol 1e-6): the colour GEMM reads its
input with a leading dimension of 32, not 31, and the sigma net its encoded
points without the views beside them, which may change the CPU library's
blocking.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_torch.kernels import field_query as fq
from hashnerf_torch.models import nerf as nerf_mod
from hashnerf_torch.models.factory import (
    EMBED_HASH, EMBED_POSITIONAL, EMBED_SH, ModelConfig, NGPState, query_fn,
)
from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.ops.packed_grid import packed_encode
from hashnerf_torch.ops.positional import positional_encode
from hashnerf_torch.ops.sh_encoding import sh_encode
from hashnerf_torch.utils import profiling

# (R, S): the coarse and fine passes' samples a ray, culled blocks of 8 (a
# block is a "ray"), and per-point queries (the grid update, unblocked culling)
SHAPES = [(7, 64), (5, 192), (11, 8), (13, 1)]
HASH = dict(n_levels=4, n_features_per_level=8, log2_hashmap_size=13, base_resolution=4,
            finest_resolution=32)


def _state(kind, dtype=None, use_viewdirs=True, seed=0):
    if kind == "nerf":
        cfg = ModelConfig(i_embed=EMBED_POSITIONAL, i_embed_views=EMBED_POSITIONAL, multires=4,
                          multires_views=2, netdepth=3, netwidth=32, netdepth_fine=3,
                          netwidth_fine=32, N_importance=8, use_viewdirs=use_viewdirs,
                          compute_dtype=dtype)
    else:
        cfg = ModelConfig(i_embed=EMBED_HASH, hash_grid=HashGridConfig(**HASH), N_importance=8,
                          packed_layout=kind == "packed", log2_blocks=10 if kind == "packed" else -1,
                          use_viewdirs=use_viewdirs, compute_dtype=dtype)
    return NGPState(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _inputs(R, S, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)  # some outside the bbox
    d = rng.normal(size=(R, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    probe = rng.normal(size=(R, S, 7)).astype(np.float32)  # raw has 4, 5 or 7 channels
    return [torch.from_numpy(a) for a in (pts, vd, bbox, probe)]


def old_sh_encode(d, degree=4):
    """sh_encode as it was: every basis function materialised, then a
    stack of the degree**2 columns."""
    from hashnerf_torch.ops.sh_encoding import C0, C1, C2, C3, C4

    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, C0)]
    if degree > 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy), C2[3] * xz,
                C2[4] * (xx - yy)]
    if degree > 3:
        out += [C3[0] * y * (3 * xx - yy), C3[1] * xy * z, C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy), C3[4] * x * (4 * zz - xx - yy),
                C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
    if degree > 4:
        out += [C4[0] * xy * (xx - yy), C4[1] * yz * (3 * xx - yy), C4[2] * xy * (7 * zz - 1),
                C4[3] * yz * (7 * zz - 3), C4[4] * (zz * (35 * zz - 30) + 3),
                C4[5] * xz * (7 * zz - 3), C4[6] * (xx - yy) * (7 * zz - 1),
                C4[7] * xz * (xx - 3 * yy), C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy))]
    return torch.stack(out, dim=-1)


def old_small(net, x, seen):
    """NeRFSmall's forward on the concatenated x, as it was."""
    cfg = net.cfg
    h = x[..., : cfg.input_ch]
    views = x[..., cfg.input_ch : cfg.input_ch + cfg.input_ch_views]
    for l, layer in enumerate(net.sigma_net):
        h = net._layer(layer, h)
        if l != cfg.num_layers - 1:
            h = torch.relu(h)
    sigma, geo_feat = h[..., :1], h[..., 1:]
    h = torch.cat([views, geo_feat], dim=-1)
    seen["colour_input"] = h
    for l, layer in enumerate(net.color_net):
        h = net._layer(layer, h)
        if l != cfg.num_layers_color - 1:
            h = torch.relu(h)
    return torch.cat([h, sigma], dim=-1)


def old_query(state, pts, viewdirs, bbox, fine, seen):
    """query_fn as it was: per-sample directions, encoded on N rows and
    concatenated; the keep mask by where and cat."""
    cfg = state.cfg
    R, S = pts.shape[0], pts.shape[1]
    flat = pts.reshape(-1, 3).contiguous()
    keep = None
    if cfg.i_embed == EMBED_POSITIONAL:
        embedded = positional_encode(flat, cfg.positional)
    elif cfg.packed_layout:
        embedded, keep = packed_encode(state.hash_table, flat, bbox[0], bbox[1], state.packed_cfg)
    else:
        embedded, keep = state.encode_hash(flat, bbox)
    if cfg.use_viewdirs and viewdirs is not None:
        dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        if cfg.i_embed_views == EMBED_SH:
            dirs = old_sh_encode(dirs, cfg.sh_degree)
        elif cfg.i_embed_views == EMBED_POSITIONAL:
            dirs = positional_encode(dirs, cfg.positional_views)
        seen["views"] = dirs
        embedded = torch.cat([embedded, dirs], dim=-1)
    mlp = state.fine if (fine and state.fine is not None) else state.coarse
    raw = old_small(mlp, embedded, seen) if isinstance(mlp, NeRFSmall) else mlp(embedded)
    if keep is not None:
        sigma = torch.where(keep, raw[..., 3], torch.zeros_like(raw[..., 3]))
        raw = torch.cat([raw[..., :3], sigma[..., None], raw[..., 4:]], dim=-1)
    return raw.reshape(R, S, raw.shape[-1])


def _new_query(state, pts, vd, bbox, fine, seen, monkeypatch):
    inner = nerf_mod.field_colour_input

    def recording(views, h, S):
        seen["views"], seen["h"] = views, h
        seen["colour_input"] = c = inner(views, h, S)
        return c

    monkeypatch.setattr(nerf_mod, "field_colour_input", recording)
    try:
        return query_fn(state, pts, vd, bbox, fine=fine)
    finally:
        monkeypatch.setattr(nerf_mod, "field_colour_input", inner)


def _leaf_grads(state):
    return {n: p.grad.clone() for n, p in state.named_parameters() if p.grad is not None}


def _run(state, fn, probe):
    state.zero_grad(set_to_none=True)
    raw = fn()
    (raw * probe[..., : raw.shape[-1]]).sum().backward()
    return raw.detach(), _leaf_grads(state)


def _close(got, want, what):
    """float32 rounding: rtol 1e-6 with an absolute floor of 1e-6 of the
    tensor's largest entry (a gradient sum in another order)."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["hash", "packed"])
@pytest.mark.parametrize("R,S", SHAPES)
def test_query_matches_the_per_sample_composition(kind, dtype, R, S, monkeypatch):
    state = _state(kind, dtype)
    pts, vd, bbox, probe = _inputs(R, S)
    for fine in (False, True):
        old_seen, new_seen = {}, {}
        want, want_g = _run(state, lambda: old_query(state, pts, vd, bbox, fine, old_seen), probe)
        got, got_g = _run(state, lambda: _new_query(state, pts, vd, bbox, fine, new_seen,
                                                    monkeypatch), probe)
        # the view encoding once a ray: the per-sample rows, bit for bit
        assert new_seen["views"].shape == (R, 16)
        assert torch.equal(new_seen["views"].repeat_interleave(S, dim=0), old_seen["views"])
        c_new, c_old = new_seen["colour_input"].detach(), old_seen["colour_input"].detach()
        assert c_new.shape == c_old.shape == (R * S, 31) and c_new.stride() == (32, 1)
        # K9's row from the sigma net's output it was given, bit for bit ...
        h = new_seen["h"].detach()
        assert torch.equal(c_new, torch.cat([new_seen["views"].repeat_interleave(S, dim=0),
                                             h[:, 1:]], dim=-1))
        # ... and equal to the reference's colour input
        assert torch.equal(c_new, c_old), f"fine={fine}"
        assert got.shape == want.shape == (R, S, 4)
        _close(got, want, f"raw fine={fine}")
        assert set(got_g) == set(want_g) and got_g
        for name in want_g:
            _close(got_g[name], want_g[name], f"{name} fine={fine}")


@pytest.mark.parametrize("kind", ["hash", "nerf"])
def test_query_without_viewdirs(kind, monkeypatch):
    state = _state(kind, use_viewdirs=False)
    pts, vd, bbox, probe = _inputs(6, 8)
    old_seen, new_seen = {}, {}
    want, want_g = _run(state, lambda: old_query(state, pts, vd, bbox, True, old_seen), probe)
    profiling.reset_counters()
    got, got_g = _run(state, lambda: _new_query(state, pts, vd, bbox, True, new_seen, monkeypatch),
                      probe)
    assert profiling.counters()["views_per_ray"] == 0
    if kind == "hash":
        # no views: the colour input is the geo features, in rows of 16
        assert new_seen["views"] is None and new_seen["colour_input"].stride() == (16, 1)
        assert torch.equal(new_seen["colour_input"], old_seen["colour_input"])
    assert got.shape == want.shape
    _close(got, want, "raw")
    for name in want_g:
        _close(got_g[name], want_g[name], name)


@pytest.mark.parametrize("R,S", SHAPES)
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_nerf_family_query_widens_the_views(dtype, R, S):
    """NeRF's views widened to the samples inside forward_rays, as the
    concatenated input carried them: raw and gradients as before."""
    state = _state("nerf", dtype)
    pts, vd, bbox, probe = _inputs(R, S, seed=4)
    for fine in (False, True):
        want, want_g = _run(state, lambda: old_query(state, pts, vd, bbox, fine, {}), probe)
        got, got_g = _run(state, lambda: query_fn(state, pts, vd, bbox, fine=fine), probe)
        _close(got, want, "raw")
        for name in want_g:
            _close(got_g[name], want_g[name], name)
    with pytest.raises(ValueError, match="keep"):
        state.coarse.forward_rays(torch.zeros(4, 27), torch.zeros(4, 15), 1,
                                  torch.ones(4, dtype=torch.bool))


def test_views_per_ray_counts_each_call_once():
    state = _state("hash")
    pts, vd, bbox, _ = _inputs(5, 64)
    profiling.reset_counters()
    with torch.no_grad():
        query_fn(state, pts, vd, bbox)
        query_fn(state, pts, vd, bbox, fine=True)
    assert profiling.counters()["views_per_ray"] == 2


@pytest.mark.parametrize("S", [1, 8])
def test_views_gradient_sums_a_rays_samples(S):
    """Where the views require a gradient (NeRFSmall's call on a
    concatenated x), each ray's is the sum over its samples, as autograd
    gives it through the expand of the reference."""
    net = NeRFSmall(NeRFSmallConfig(), torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    R = 6
    x = torch.from_numpy(rng.normal(size=(R * S, 32)).astype(np.float32))
    views = torch.from_numpy(rng.normal(size=(R, 16)).astype(np.float32)).requires_grad_(True)
    probe = torch.from_numpy(rng.normal(size=(R * S, 4)).astype(np.float32))
    (net.forward_rays(x, views, S) * probe).sum().backward()
    got = views.grad.clone()
    views.grad = None
    wide = views[:, None, :].expand(R, S, 16).reshape(-1, 16)
    (old_small(net, torch.cat([x, wide], dim=-1), {}) * probe).sum().backward()
    _close(got, views.grad, "views")
    # the JAX package's call on x: the same raw as forward_rays with S = 1
    xc = torch.cat([x, wide.detach()], dim=-1)
    with torch.no_grad():
        assert torch.equal(net(xc), net.forward_rays(x, wide.detach(), 1))
        assert net(xc.reshape(R, S, 48)).shape == (R, S, 4)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sh_encode_writes_the_stacked_columns(degree, dtype):
    """sh_encode's columns, each written in place, equal the stacked
    formulation bit for bit (any leading shape)."""
    d = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 40, 3)).astype(np.float32))
    d = (d / d.norm(dim=-1, keepdim=True)).to(dtype)
    got = sh_encode(d, degree)
    assert got.shape == (6, 40, degree * degree) and got.dtype == dtype
    assert torch.equal(got, old_sh_encode(d, degree))


@pytest.mark.parametrize("degree", [2, 4, 5])
def test_sh_encode_keeps_the_directions_gradient(degree):
    """Directions that require a gradient take the stacked columns: the
    same values as the in-place form, and the stacked formulation's
    gradient."""
    d0 = torch.from_numpy(np.random.default_rng(6).normal(size=(9, 3)).astype(np.float32))
    d0 = d0 / d0.norm(dim=-1, keepdim=True)
    w = torch.from_numpy(np.random.default_rng(7).normal(size=(9, degree**2)).astype(np.float32))
    d, d_old = d0.clone().requires_grad_(True), d0.clone().requires_grad_(True)
    got = sh_encode(d, degree)
    assert got.requires_grad and torch.equal(got.detach(), sh_encode(d0, degree))
    (got * w).sum().backward()
    (old_sh_encode(d_old, degree) * w).sum().backward()
    torch.testing.assert_close(d.grad, d_old.grad, rtol=1e-6, atol=0)


def test_plain_versions_and_their_checks():
    """The plain rows: padded colour input (pad +0), raw under the keep mask
    (a NaN sigma outside it reads 0), and the backwards' layouts."""
    views = torch.arange(2 * 3, dtype=torch.float32).reshape(2, 3)
    h = torch.arange(4 * 5, dtype=torch.float32).reshape(4, 5) + 100
    c = fq.field_colour_input_fwd(views, h, 2)
    assert c.shape == (4, 7) and c.stride() == (8, 1)
    assert torch.equal(c, torch.cat([views.repeat_interleave(2, dim=0), h[:, 1:]], dim=-1))
    assert torch.equal(c.as_strided((4, 8), (8, 1))[:, 7], torch.zeros(4))
    g = torch.arange(4 * 7, dtype=torch.float32).reshape(4, 7)
    d_h = fq.field_colour_input_bwd(g, 3, 5)
    assert torch.equal(d_h, torch.cat([torch.zeros(4, 1), g[:, 3:]], dim=-1))
    rgb = torch.ones(4, 3)
    h[2, 0] = float("nan")
    keep = torch.tensor([True, False, False, True])
    raw = fq.field_raw_fwd(rgb, h, keep)
    assert torch.equal(raw, torch.tensor([[1, 1, 1, 100], [1, 1, 1, 0], [1, 1, 1, 0],
                                          [1, 1, 1, 115.0]]))
    g4 = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    d_h = fq.field_raw_bwd(g4, keep, 5)
    assert torch.equal(d_h[:, 0], torch.tensor([3.0, 0, 0, 15])) and not d_h[:, 1:].any()
    # a cotangent may come expanded (stride 0)
    assert torch.equal(fq.field_raw_bwd(torch.ones(1, 4).expand(4, 4), None, 5)[:, 0],
                       torch.ones(4))
    with pytest.raises(ValueError):
        fq.field_colour_input_fwd(views, h[:3], 2)  # 3 rows are not 2 samples a ray
    with pytest.raises(ValueError):
        fq.field_colour_input_fwd(views[:1], h, 2)  # one ray for 4 rows
    with pytest.raises(TypeError):
        fq.field_raw_fwd(rgb.double(), h, keep)
    with pytest.raises(ValueError):
        fq.field_raw_fwd(rgb, h, keep[:3])
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain path taken
        fq.field_raw_fwd(rgb.to("meta"), h.to("meta"), None)
