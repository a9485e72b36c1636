"""The port's model and renderer against the reference goldens
(tests/golden/reference_golden.npz, as tests/test_golden_reference.py uses
them) and against the JAX renderer from one state, with the random draws
taken from JAX's keys and handed to the port."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn
from hashnerf_torch.ops.hash_encoding import HashGridConfig
from hashnerf_torch.render.renderer import RenderConfig, RenderDraws, render, render_rays

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "reference_golden.npz")
HCFG = HashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=12,
                      base_resolution=16, finest_resolution=512)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def port_state(g):
    """NGPState with the golden table and MLP weights (already (out, in))."""
    state = NGPState(ModelConfig(N_importance=32, hash_grid=HCFG), device="cpu")
    with torch.no_grad():
        state.hash_table.copy_(_t(g["hash_table_render"]))
        for which in ("coarse", "fine"):
            net = getattr(state, which)
            for i, layer in enumerate(net.sigma_net):
                layer.weight.copy_(_t(g[f"mlp_{which}_sigma_net_{i}"]))
            for i, layer in enumerate(net.color_net):
                layer.weight.copy_(_t(g[f"mlp_{which}_color_net_{i}"]))
    return state


def _jax_mlp(g, which):
    return {
        "sigma_net": [{"w": jnp.asarray(g[f"mlp_{which}_sigma_net_{i}"].T)} for i in range(2)],
        "color_net": [{"w": jnp.asarray(g[f"mlp_{which}_color_net_{i}"].T)} for i in range(3)],
    }


@pytest.fixture(scope="module")
def jax_setup(g):
    from hashnerf_tpu.models.factory import ModelConfig as JModelConfig, NGPState as JState
    from hashnerf_tpu.models.factory import create_model
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JCfg

    jcfg = JCfg(n_levels=16, n_features_per_level=2, log2_hashmap_size=12)
    _, jquery = create_model(jax.random.PRNGKey(0), JModelConfig(N_importance=32, hash_grid=jcfg))
    state = JState(hash_table=jnp.asarray(g["hash_table_render"]),
                   coarse=_jax_mlp(g, "coarse"), fine=_jax_mlp(g, "fine"))
    return state, jquery


def _bbox(g):
    return torch.stack([_t(g["hash_bbox_min"]), _t(g["hash_bbox_max"])])


def _batch(g):
    rb = g["rr_ray_batch"]
    return {"rays_o": _t(rb[:, 0:3]), "rays_d": _t(rb[:, 3:6]), "near": _t(rb[:, 6]),
            "far": _t(rb[:, 7]), "viewdirs": _t(rb[:, 8:11])}


RCFG = RenderConfig(N_samples=32, N_importance=32, perturb=False, raw_noise_std=0.0,
                    white_bkgd=True, use_viewdirs=True)


def _render(state, g, cfg=RCFG, draws=None):
    b = _batch(g)
    return render_rays(state, query_fn, b["rays_o"], b["rays_d"], b["viewdirs"],
                       b["near"], b["far"], _bbox(g), cfg, draws=draws)


def test_nerf_small_matches_jax(g):
    from hashnerf_tpu.models.nerf import NeRFSmallConfig, apply_nerf_small

    x = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
    want = apply_nerf_small(_jax_mlp(g, "coarse"), jnp.asarray(x), NeRFSmallConfig())
    state = NGPState(ModelConfig(N_importance=32, hash_grid=HCFG), device="cpu")
    with torch.no_grad():
        for i, layer in enumerate(state.coarse.sigma_net):
            layer.weight.copy_(_t(g[f"mlp_coarse_sigma_net_{i}"]))
        for i, layer in enumerate(state.coarse.color_net):
            layer.weight.copy_(_t(g[f"mlp_coarse_color_net_{i}"]))
        got = state.coarse(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_render_rays_matches_reference(g, port_state):
    with torch.no_grad():
        ret = {k: v.numpy() for k, v in _render(port_state, g).items()}
    np.testing.assert_allclose(ret["rgb_map"], g["rr_rgb"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ret["depth_map"], g["rr_depth"], rtol=1e-3, atol=3e-4)
    np.testing.assert_allclose(ret["acc_map"], g["rr_acc"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ret["rgb0"], g["rr_rgb0"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ret["depth0"], g["rr_depth0"], rtol=1e-3, atol=3e-4)
    np.testing.assert_allclose(ret["acc0"], g["rr_acc0"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ret["sparsity_loss"], g["rr_sparsity"], rtol=1e-2)
    np.testing.assert_allclose(ret["z_std"], g["rr_z_std"], rtol=1e-3, atol=1e-5)


def test_render_pixel_gradients_match_reference(g, port_state):
    """Pixel-loss gradients (hash table through K3 + K1's plain path, and
    both MLPs) against the reference's autograd."""
    port_state.zero_grad(set_to_none=True)
    ret = _render(port_state, g)
    target = _t(g["rr_target"])
    loss = torch.mean((ret["rgb_map"] - target) ** 2) + torch.mean((ret["rgb0"] - target) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(g["rr_loss"]), rtol=1e-4)
    np.testing.assert_allclose(port_state.hash_table.grad.numpy(), g["rr_table_grad"],
                               rtol=5e-3, atol=3e-5)
    np.testing.assert_allclose(port_state.coarse.sigma_net[0].weight.grad.numpy(),
                               g["rr_sigma0_w_grad"], rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(port_state.fine.sigma_net[0].weight.grad.numpy(),
                               g["rr_fine_sigma0_w_grad"], rtol=5e-3, atol=1e-5)
    port_state.zero_grad(set_to_none=True)


def test_render_rays_matches_jax_with_injected_draws(g, port_state, jax_setup):
    """perturb and sigma noise on: the port gets JAX's own draws."""
    from hashnerf_tpu.render.renderer import RenderConfig as JRC, render_rays as jrr

    jstate, jquery = jax_setup
    jcfg = JRC(N_samples=32, N_importance=32, perturb=True, raw_noise_std=0.5,
               white_bkgd=True, use_viewdirs=True)
    cfg = RenderConfig(N_samples=32, N_importance=32, perturb=True, raw_noise_std=0.5,
                       white_bkgd=True, use_viewdirs=True)
    key = jax.random.PRNGKey(11)
    rb = g["rr_ray_batch"]
    R = rb.shape[0]
    bbox_j = jnp.stack([jnp.asarray(g["hash_bbox_min"]), jnp.asarray(g["hash_bbox_max"])])

    def jloss(state):
        ret = jrr(state, jquery, jnp.asarray(rb[:, 0:3]), jnp.asarray(rb[:, 3:6]),
                  jnp.asarray(rb[:, 8:11]), jnp.asarray(rb[:, 6]), jnp.asarray(rb[:, 7]),
                  bbox_j, key, jcfg)
        return jnp.sum(ret["rgb_map"]) + jnp.sum(ret["rgb0"]), ret

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jstate)

    k_strat, k_noise0, k_pdf, k_noise1 = jax.random.split(key, 4)
    draws = RenderDraws(
        t_strat=_t(jax.random.uniform(k_strat, (R, 32))),
        noise0=_t(jax.random.normal(k_noise0, (R, 32))),
        u_pdf=_t(jax.random.uniform(k_pdf, (R, 32))),
        noise1=_t(jax.random.normal(k_noise1, (R, 64))),
    )
    port_state.zero_grad(set_to_none=True)
    got = _render(port_state, g, cfg, draws)
    (got["rgb_map"].sum() + got["rgb0"].sum()).backward()
    # the jitted JAX encoder's weights differ from IEEE op-by-op arithmetic by
    # up to ~1 ulp of the grid coordinate (test_torch_ops), hence 1e-4
    for k in ("rgb_map", "rgb0", "acc_map", "acc0", "depth_map", "z_std", "sparsity_loss"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(port_state.hash_table.grad.numpy(), np.asarray(jgrad.hash_table),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(port_state.fine.color_net[0].weight.grad.numpy(),
                               np.asarray(jgrad.fine["color_net"][0]["w"]).T, rtol=1e-3, atol=1e-5)
    port_state.zero_grad(set_to_none=True)


def test_chunked_render_matches_jax(g, port_state, jax_setup):
    from hashnerf_tpu.render.renderer import RenderConfig as JRC, render as jrender
    from hashnerf_torch.data.pose_paths import pose_spherical

    jstate, jquery = jax_setup
    H = W = 6
    focal = 0.5 * W / np.tan(0.5 * 0.6911)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32)
    c2w = pose_spherical(40.0, -30.0, 4.0)[:3, :4]
    bbox_j = jnp.stack([jnp.asarray(g["hash_bbox_min"]), jnp.asarray(g["hash_bbox_max"])])
    jcfg = JRC(N_samples=32, N_importance=32, perturb=False, white_bkgd=True)
    rgb_j, depth_j, acc_j, _ = jrender(jstate, jquery, H, W, K, bbox_j, jcfg, chunk=16,
                                       c2w=jnp.asarray(c2w), near=2.0, far=6.0)
    rgb, depth, acc, extras = render(port_state, query_fn, H, W, K, _bbox(g), RCFG, chunk=16,
                                     c2w=_t(c2w), near=2.0, far=6.0)
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W) and "rgb0" in extras
    assert float(acc.max()) > 0.0  # the view crosses the bbox
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), rtol=1e-3, atol=3e-4)
