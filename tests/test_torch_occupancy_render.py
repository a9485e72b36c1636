"""The port's query_with_culling and render_rays against the JAX package on
the CPU, in every culling mode (global at block 1 and 8 with each
partition, per ray with each selection, strided scores, the eval budgets
with the transmittance cull) and with fast_merge, from one state loaded
through convert.py, packed and per-corner, with the random draws taken
from JAX's keys.

The JAX package runs op by op (jax.disable_jit), as the port does. The
culled query and the coarse pass are held at rtol 1e-5 / atol 1e-6; the
fine pass at rtol 1e-4 / atol 5e-5 (its samples come from an inverse CDF,
see test_render_rays_matches_jax); table gradients at rtol 1e-4 and atol
1e-6 (query) or 1e-5 (render): float32 sums in other orders.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from hashnerf_tpu.render import occupancy as jocc
from hashnerf_torch.render import occupancy as tocc
from test_torch_occupancy import BBOX, _cfgs, _t, ray_batch, ray_pts, tie_grid


# --------------------------------------------------------------------------- #
# query_with_culling and render_rays, from one state
# --------------------------------------------------------------------------- #

HASH = dict(n_levels=4, log2_hashmap_size=13, finest_resolution=32)


def make_states(packed):
    """(JAX state, JAX query_fn, port state) with normal tables (features of
    size 1) and the JAX MLPs, the sigma output's weights scaled by 30 so
    that the rays see density."""
    from hashnerf_tpu.models.factory import ModelConfig as JModelConfig, create_model
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JHash
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState
    from hashnerf_torch.ops.hash_encoding import HashGridConfig

    F = 8 if packed else 2
    common = dict(N_importance=16, share_fine=packed, packed_layout=packed, log2_blocks=10)
    js, jquery = create_model(jax.random.PRNGKey(1), JModelConfig(
        hash_grid=JHash(n_features_per_level=F, **HASH), **common))
    rng = np.random.default_rng(2)
    tables = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), js.hash_table)
    to_np = lambda tree: None if tree is None else jax.tree_util.tree_map(np.array, tree)
    nets = [to_np(js.coarse), to_np(js.fine)]
    for net in nets:
        if net is not None:
            net["sigma_net"][-1]["w"][:, 0] *= 30.0
    js = js._replace(hash_table=jax.tree_util.tree_map(jnp.asarray, tables),
                     coarse=jax.tree_util.tree_map(jnp.asarray, nets[0]),
                     fine=None if nets[1] is None else jax.tree_util.tree_map(jnp.asarray, nets[1]))
    ts = NGPState(ModelConfig(hash_grid=HashGridConfig(n_features_per_level=F, **HASH), **common),
                  device="cpu")
    load_jax_state(ts, tables, *nets)
    return js, jquery, ts


_STATES = {}


def states(layout):
    if layout not in _STATES:
        _STATES[layout] = make_states(layout == "packed")
    return _STATES[layout]


def _table_grads(ts):
    if isinstance(ts.hash_table, torch.nn.ParameterDict):
        return {k: v.grad.numpy() for k, v in ts.hash_table.items()}
    return {"": ts.hash_table.grad.numpy()}


def _jax_table_grads(g):
    return {k: np.asarray(v) for k, v in g.items()} if isinstance(g, dict) else {"": np.asarray(g)}


@pytest.mark.parametrize("layout,block,mode", [
    ("unpacked", 1, "sort1"), ("packed", 1, "sort2"), ("unpacked", 8, "cumsum"), ("packed", 8, "sort1"),
])
def test_query_with_culling_matches_jax(layout, block, mode):
    from hashnerf_torch.models.factory import query_fn

    js, jquery, ts = states(layout)
    jc, tc = _cfgs(resolution=32, block=block, partition=mode)
    grid = tie_grid(32, 6)
    pts = ray_pts(24, 16, 7)
    vd = np.random.default_rng(8).normal(size=(24, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    keep_k = 128
    probe = np.random.default_rng(9).normal(size=(24, 16, 4)).astype(np.float32)

    def jf(state):
        raw = jocc.query_with_culling(jquery, state, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(BBOX),
                                      jnp.asarray(grid), jc, keep_k, fine=True)
        return jnp.sum(raw * probe), raw

    with jax.disable_jit():
        (_, want), gj = jax.value_and_grad(jf, has_aux=True)(js)
    ts.zero_grad(set_to_none=True)
    got = tocc.query_with_culling(query_fn, ts, _t(pts), _t(vd), _t(BBOX), _t(grid), tc, keep_k,
                                  fine=True)
    (got * _t(probe)).sum().backward()
    want = np.asarray(want)
    assert (want == 0).all(-1).sum() == 24 * 16 - keep_k  # the culled points read 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    gt, gjt = _table_grads(ts), _jax_table_grads(gj.hash_table)
    for k in gt:
        np.testing.assert_allclose(gt[k], gjt[k], rtol=1e-4, atol=1e-6, err_msg=k)


# name: (state layout, occupancy kwargs or None, RenderConfig kwargs, eval_mode)
RENDER_CASES = {
    "block1": ("unpacked", dict(keep_fraction=0.5), {}, False),
    "block1_cumsum": ("unpacked", dict(keep_fraction=0.5, partition="cumsum"), {}, False),
    "block8": ("packed", dict(keep_fraction=0.125, keep_fraction_coarse=0.375, block=8), {}, False),
    "block8_sort2_clip": ("packed", dict(keep_fraction=0.25, block=8, partition="sort2"),
                          dict(aabb_clip=True), False),
    "per_ray_sort": ("packed", dict(keep_fraction=0.25, keep_fraction_coarse=0.5, per_ray=True), {},
                     False),
    "per_ray_topk": ("unpacked", dict(keep_fraction=0.25, per_ray=True, per_ray_select="topk"), {},
                     False),
    "per_ray_approx": ("unpacked", dict(keep_fraction=0.25, per_ray=True, per_ray_select="approx"),
                       {}, False),
    "stride2_block8": ("packed", dict(keep_fraction=0.25, block=8, score_stride=2), {}, False),
    "stride2_per_ray": ("unpacked", dict(keep_fraction=0.25, per_ray=True, score_stride=2), {}, False),
    "eval_transmittance": ("packed", dict(keep_fraction=0.125, block=8, keep_fraction_eval=0.5,
                                          eval_transmittance=True), {}, True),
    "eval_transmittance_per_ray": ("unpacked", dict(keep_fraction=0.125, per_ray=True,
                                                    keep_fraction_eval=0.5,
                                                    keep_fraction_eval_coarse=0.75,
                                                    eval_transmittance=True), {}, True),
    "fast_merge": ("unpacked", None, dict(fast_merge=True), False),
    "fast_merge_eval": ("packed", None, dict(fast_merge=True), True),
    "fast_merge_with_grid": ("packed", dict(keep_fraction=0.25, block=8), dict(fast_merge=True), False),
}


# the cases whose table gradients are compared too (JAX's eager backward
# is slow)
GRAD_CASES = ("block8", "per_ray_sort")


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_rays_matches_jax(case):
    from hashnerf_tpu.ops.sampling import sorted_uniform as jsorted_uniform
    from hashnerf_tpu.render.renderer import RenderConfig as JRC, render_rays as jrr
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.render.renderer import RenderConfig, RenderDraws, render_rays

    layout, occ_kw, kw, eval_mode = RENDER_CASES[case]
    js, jquery, ts = states(layout)
    Rr, Ns, Ni = 32, 16, 16
    common = dict(N_samples=Ns, N_importance=Ni, perturb=True, white_bkgd=True, **kw)
    jcfg = JRC(occupancy=None if occ_kw is None else jocc.OccupancyConfig(resolution=32, **occ_kw),
               **common)
    tcfg = RenderConfig(occupancy=None if occ_kw is None else tocc.OccupancyConfig(resolution=32, **occ_kw),
                        **common)
    if eval_mode:
        jcfg, tcfg = jcfg.eval_mode(), tcfg.eval_mode()
        assert tcfg.occupancy is None or tcfg.occupancy.transmittance_cull
    grid = tie_grid(32, 10, occupied=0.1)
    o, d = ray_batch(Rr, 11)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full(Rr, 2.0, np.float32), np.full(Rr, 6.0, np.float32)
    key = jax.random.PRNGKey(12)
    k_strat, _, k_pdf, _ = jax.random.split(key, 4)

    def jf(state):
        ret = jrr(state, jquery, *(jnp.asarray(a) for a in (o, d, vd, near, far, BBOX)), key, jcfg,
                  occ_grid=jnp.asarray(grid))
        return jnp.sum(ret["rgb_map"]) + jnp.sum(ret["rgb0"]), ret

    grads = case in GRAD_CASES
    with jax.disable_jit():
        if grads:
            (_, want), gj = jax.value_and_grad(jf, has_aux=True)(js)
        else:
            want = jf(js)[1]
    draws = RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (Rr, Ns))),
                        u_pdf=_t(jax.random.uniform(k_pdf, (Rr, Ni))),
                        u_sorted=_t(jsorted_uniform(k_pdf, (Rr, Ni))))
    ts.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(grads):
        got = render_rays(ts, query_fn, *(_t(a) for a in (o, d, vd, near, far, BBOX)), tcfg,
                          draws=draws, occ_grid=_t(grid))
    assert float(np.asarray(want["acc_map"]).max()) > 0.1  # the rays see density
    for k in ("rgb0", "acc0", "depth0", "sparsity_loss0"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # The fine pass samples where the inverse CDF of the coarse weights puts
    # it, dividing by bin masses down to sample_pdf's 1e-5 floor: the ulps
    # by which XLA's and PyTorch's exp differ move a sample by up to ~1e-5.
    for k in ("rgb_map", "acc_map", "depth_map", "sparsity_loss", "z_std"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-4, atol=5e-5,
                                   err_msg=k)
    if grads:
        (got["rgb_map"].sum() + got["rgb0"].sum()).backward()
        gt, gjt = _table_grads(ts), _jax_table_grads(gj.hash_table)
        for k in gt:
            # the fine pass's share moves with its samples, as above
            np.testing.assert_allclose(gt[k], gjt[k], rtol=1e-4, atol=1e-5, err_msg=k)
