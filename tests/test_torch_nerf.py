"""The classic NeRF family in the port against the JAX package on the CPU:
the positional encoder (and the golden reference's pe_out), NeRF and
NeRFGradient forward and gradients (float32 and bfloat16), the Keras weight
import, the factory's query_fn for every point and view encoder without the
hash grid, convert and load_jax_checkpoint of a NeRF state with optax.adam's
state, Adam against optax.adam, and Trainer steps of the NeRF family against
JAX's eager step."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------- #
# The positional encoder
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("num_freqs,log_sampling,include_input", [
    (10, True, True), (4, True, True), (6, False, False),
])
def test_positional_encode_matches_jax(num_freqs, log_sampling, include_input):
    from hashnerf_tpu.ops.positional import PositionalConfig as JCfg, positional_encode as jpe
    from hashnerf_torch.ops.positional import PositionalConfig, positional_encode

    kw = dict(num_freqs=num_freqs, max_freq_log2=num_freqs - 1, include_input=include_input,
              log_sampling=log_sampling)
    cfg, jcfg = PositionalConfig(**kw), JCfg(**kw)
    # the bands are JAX's float64 numbers, bit for bit
    assert cfg.freq_bands == jcfg.freq_bands and cfg.out_dim == jcfg.out_dim
    x = np.random.default_rng(0).uniform(-2, 2, (300, 3)).astype(np.float32)
    got = positional_encode(_t(x), cfg).numpy()
    want = np.asarray(jpe(jnp.asarray(x), jcfg))
    assert got.shape == want.shape == (300, cfg.out_dim)
    # sin and cos of the same float32 products, within an ulp of each
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7)


def test_positional_encode_matches_golden():
    from hashnerf_torch.ops.positional import PositionalConfig, positional_encode

    g = np.load(os.path.join(ROOT, "tests", "golden", "reference_golden.npz"))
    out = positional_encode(_t(g["pe_in"]), PositionalConfig(num_freqs=10, max_freq_log2=9))
    np.testing.assert_allclose(out.numpy(), g["pe_out"], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# NeRF and NeRFGradient
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("gradient", [False, True], ids=["nerf", "nerf_gradient"])
@pytest.mark.parametrize("viewdirs", [True, False], ids=["viewdirs", "no_viewdirs"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_nerf_matches_jax(gradient, viewdirs, dtype):
    """D 6, W 32, skip after layer 4: outputs and the gradients of every
    weight, bias and the input. float32 outputs at rtol 1e-5 / atol 1e-6,
    gradients at atol 1e-5 (a weight's gradient sums 400 products, entries
    up to 6, in other orders); bfloat16 operands at the bfloat16 tests' 2e-3
    / 1e-4 on outputs and 2e-2 / 1e-4 on gradients (test_torch_float16.py)."""
    from hashnerf_tpu.models import nerf as jn
    from hashnerf_torch.convert import _load_mlp
    from hashnerf_torch.models.nerf import NeRF, NeRFConfig, NeRFGradient

    kw = dict(D=6, W=32, input_ch=21, input_ch_views=9, output_ch=5, skips=(4,),
              use_viewdirs=viewdirs)
    jcfg = jn.NeRFConfig(**kw)
    init, apply = ((jn.init_nerf_gradient, jn.apply_nerf_gradient) if gradient
                   else (jn.init_nerf, jn.apply_nerf))
    params = init(jax.random.PRNGKey(3), jcfg)
    jdt = None if dtype is None else jnp.dtype(dtype)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 30)).astype(np.float32)
    n_out = (7 if gradient else 4) if viewdirs else 5
    probe = rng.normal(size=(400, n_out)).astype(np.float32)
    yj = apply(params, jnp.asarray(x), jcfg, jdt)
    gp, gx = jax.grad(lambda p, x_: jnp.sum(apply(p, x_, jcfg, jdt) * probe),
                      argnums=(0, 1))(params, jnp.asarray(x))

    net = (NeRFGradient if gradient else NeRF)(NeRFConfig(**kw, compute_dtype=dtype))
    with torch.no_grad():
        _load_mlp(net, to_np(params))
    xt = _t(x).requires_grad_(True)
    yt = net(xt)
    (yt * _t(probe)).sum().backward()
    tol_y, tol_g = (dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-5, atol=1e-5)) if dtype is None else (
        dict(rtol=2e-3, atol=1e-4), dict(rtol=2e-2, atol=1e-4))
    assert yt.shape == (400, n_out)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **tol_y)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol_g)
    jgrads = to_np(gp)
    for name, child in net.named_children():
        layers = child if isinstance(child, torch.nn.ModuleList) else [child]
        jl = jgrads[name] if isinstance(jgrads[name], list) else [jgrads[name]]
        for i, (layer, g) in enumerate(zip(layers, jl)):
            np.testing.assert_allclose(layer.weight.grad.numpy(), g["w"].T, **tol_g,
                                       err_msg=f"{name}[{i}].w")
            np.testing.assert_allclose(layer.bias.grad.numpy(), g["b"], **tol_g,
                                       err_msg=f"{name}[{i}].b")


def test_keras_import_matches_jax():
    from hashnerf_tpu.models import nerf as jn
    from hashnerf_torch.models.nerf import NeRF, NeRFConfig, load_nerf_weights_from_keras

    kw = dict(D=8, W=32, input_ch=63, input_ch_views=27, use_viewdirs=True)
    rng = np.random.default_rng(4)
    # the TF-NeRF list: [W (in, out), b] for pts_linears, feature, views, rgb, alpha
    shapes = ([(63, 32)] + [(32 + 63 if i == 5 else 32, 32) for i in range(1, 8)]
              + [(32, 32), (32 + 27, 16), (16, 3), (32, 1)])
    weights = []
    for fan_in, fan_out in shapes:
        weights += [rng.normal(size=(fan_in, fan_out)).astype(np.float32) * 0.2,
                    rng.normal(size=(1, fan_out)).astype(np.float32) * 0.1]
    jcfg = jn.NeRFConfig(**kw)
    params = jn.load_nerf_weights_from_keras(weights, jcfg)
    net = load_nerf_weights_from_keras(NeRF(NeRFConfig(**kw)), weights)
    x = rng.normal(size=(200, 90)).astype(np.float32)
    with torch.no_grad():
        got = net(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jn.apply_nerf(params, jnp.asarray(x), jcfg)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        load_nerf_weights_from_keras(NeRF(NeRFConfig(**{**kw, "use_viewdirs": False})), weights)


# --------------------------------------------------------------------------- #
# The factory
# --------------------------------------------------------------------------- #

def _models(i_embed, i_embed_views, use_gradient=False, N_importance=8, use_viewdirs=True):
    """The JAX (state, query_fn) and the port's NGPState with JAX's weights."""
    from hashnerf_tpu.models.factory import ModelConfig as JCfg, create_model
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState

    kw = dict(i_embed=i_embed, i_embed_views=i_embed_views, multires=6, multires_views=3,
              use_viewdirs=use_viewdirs, use_gradient=use_gradient, N_importance=N_importance,
              netdepth=6, netwidth=32, netdepth_fine=7, netwidth_fine=48)
    js, jq = create_model(jax.random.PRNGKey(0), JCfg(**kw))
    state = NGPState(ModelConfig(**kw))
    load_jax_state(state, None, to_np(js.coarse), to_np(js.fine))
    return js, jq, state


@pytest.mark.parametrize("i_embed,i_embed_views", [
    (-1, -1), (-1, 0), (-1, 2), (0, -1), (0, 0), (0, 2), (2, 0),
])
def test_query_fn_matches_jax(i_embed, i_embed_views):
    """NeRF coarse (6 x 32) and fine (7 x 48) nets behind each encoder pair:
    raw of both passes at rtol 1e-5 / atol 1e-6; no table, every point kept
    (sigma is not zeroed outside the bbox)."""
    from hashnerf_torch.models.factory import query_fn

    js, jq, state = _models(i_embed, i_embed_views)
    assert js.hash_table is None and state.hash_table is None and state.table_parameters() == []
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (16, 8, 3)).astype(np.float32)  # some outside the bbox
    d = rng.normal(size=(16, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    bbox = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    for fine in (False, True):
        want = np.asarray(jq(js, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(bbox), fine=fine))
        with torch.no_grad():
            got = query_fn(state, _t(pts), _t(vd), _t(bbox), fine=fine).numpy()
        assert got.shape == want.shape == (16, 8, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"fine={fine}")


def test_query_fn_nerf_gradient_matches_jax():
    from hashnerf_torch.models.factory import query_fn
    from hashnerf_torch.models.nerf import NeRFGradient

    js, jq, state = _models(0, 0, use_gradient=True)
    assert isinstance(state.coarse, NeRFGradient) and isinstance(state.fine, NeRFGradient)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    vd = rng.normal(size=(8, 3)).astype(np.float32)
    bbox = np.array([[-2.0] * 3, [2.0] * 3], np.float32)
    want = np.asarray(jq(js, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(bbox), fine=True))
    with torch.no_grad():
        got = query_fn(state, _t(pts), _t(vd), _t(bbox), fine=True).numpy()
    assert got.shape == (8, 8, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_query_fn_at_the_published_widths_matches_jax():
    """The classic NeRF as nerf-pytorch's lego.txt runs it: D 8, W 256, skip
    after layer 4, 10 / 4 positional bands (63 / 27 inputs), coarse and
    fine nets on seeded weights, 384 points a pass: raw at the smaller nets'
    rtol 1e-5 / atol 1e-6 (outputs up to 0.12 differ by at most 6e-8)."""
    from hashnerf_tpu.models.factory import ModelConfig as JCfg, create_model
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn

    kw = dict(i_embed=0, i_embed_views=0, multires=10, multires_views=4, use_viewdirs=True,
              N_importance=128, netdepth=8, netwidth=256, netdepth_fine=8, netwidth_fine=256)
    js, jq = create_model(jax.random.PRNGKey(22), JCfg(**kw))
    state = NGPState(ModelConfig(**kw))
    load_jax_state(state, None, to_np(js.coarse), to_np(js.fine))
    assert state.coarse.pts_linears[5].weight.shape == (256, 319)
    assert state.fine.views_linears[0].weight.shape == (128, 283)
    rng = np.random.default_rng(22)
    pts = rng.uniform(-2, 2, (6, 64, 3)).astype(np.float32)
    d = rng.normal(size=(6, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    bbox = np.array([[-1.6] * 3, [1.6] * 3], np.float32)
    for fine in (False, True):
        want = np.asarray(jq(js, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(bbox), fine=fine))
        with torch.no_grad():
            got = query_fn(state, _t(pts), _t(vd), _t(bbox), fine=fine).numpy()
        assert got.shape == want.shape == (6, 64, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"fine={fine}")


def test_convert_refuses_a_mismatched_nerf_state():
    from hashnerf_tpu.models.factory import ModelConfig as JCfg, create_model
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import ModelConfig, NGPState

    kw = dict(i_embed=0, i_embed_views=0, N_importance=8, netdepth=4, netwidth=32,
              netdepth_fine=4, netwidth_fine=32)
    js, _ = create_model(jax.random.PRNGKey(0), JCfg(**kw))
    # a gradient head the JAX state lacks, a wider net, a table that is not there
    for port_kw, what in ((dict(use_gradient=True), "layers"), (dict(netwidth=64), "weight"),
                          (dict(i_embed=1), "hash table")):
        state = NGPState(ModelConfig(**{**kw, **port_kw}))
        before = {k: v.clone() for k, v in state.state_dict().items()}
        with pytest.raises(ValueError, match=what):
            load_jax_state(state, None, to_np(js.coarse), to_np(js.fine))
        for k, v in state.state_dict().items():
            assert torch.equal(v, before[k]), k


# --------------------------------------------------------------------------- #
# Adam
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lrate,decay", [(5e-4, 250), (0.05, 1)])
def test_adam_matches_optax(lrate, decay):
    """10 steps of optax.adam(schedule, b1 0.9, b2 0.999) against the port's
    Adam from the same parameters and gradients, at rtol 1e-6 / atol 1e-8."""
    import optax
    from hashnerf_tpu.train.driver import make_lr_schedule as jsched
    from hashnerf_torch.train.adam import Adam
    from hashnerf_torch.train.driver import make_lr_schedule

    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for k, v in p0.items()} for _ in range(10)]
    opt_j = optax.adam(jsched(lrate, decay), b1=0.9, b2=0.999)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = opt_j.init(pj)
    pt = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt_t = Adam(list(pt.values()), lr=make_lr_schedule(lrate, decay), betas=(0.9, 0.999), eps=1e-8)
    for i, g in enumerate(grads):
        upd, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = _t(g[k])
        opt_t.step()
        for k, p in pt.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k}, step {i + 1}")
            st = opt_t.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(sj[0].mu[k]), rtol=1e-6,
                                       atol=1e-12)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(sj[0].nu[k]), rtol=1e-6,
                                       atol=1e-15)
            assert float(st["step"]) == int(sj[0].count) == i + 1
    assert not np.allclose(pt["a"].detach().numpy(), p0["a"])


# --------------------------------------------------------------------------- #
# Trainer steps and checkpoints of the NeRF family
# --------------------------------------------------------------------------- #

SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=5e-3, lrate_decay=10,
                use_viewdirs=True, white_bkgd=True, no_batching=True, perturb=1.0,
                raw_noise_std=1.0, i_embed=0, i_embed_views=0, multires=6, multires_views=3,
                netdepth=4, netwidth=32, netdepth_fine=4, netwidth_fine=32)


def _args(parser, **kw):
    args = parser.parse_args([])
    for k, v in {**SETTINGS, **kw}.items():
        setattr(args, k, v)
    return args


def _batches(sj, n, seed):
    from hashnerf_tpu.ops.rays import get_rays_np

    R = SETTINGS["N_rand"]
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img = int(rng.integers(0, 3))
        ys, xs = rng.integers(0, 24, R), rng.integers(0, 24, R)
        ro, rd = get_rays_np(24, 24, sj.K, sj.poses[img])
        yield {"rays_o": ro[ys, xs].astype(np.float32), "rays_d": rd[ys, xs].astype(np.float32),
               "target": sj.images[img][ys, xs], "near": np.full(R, 2.0, np.float32),
               "far": np.full(R, 6.0, np.float32)}


def _draws(jt, R, S, S_imp):
    """The draws the next JAX step takes from its key: jitter, noise of
    both passes and the importance draws (the NeRF family has no TV)."""
    from hashnerf_torch.render.renderer import RenderDraws
    from hashnerf_torch.train.driver import TrainDraws

    _, k = jax.random.split(jt.key)
    k_render, _ = jax.random.split(k)
    k_strat, k_noise0, k_pdf, k_noise1 = jax.random.split(k_render, 4)
    return TrainDraws(render=RenderDraws(
        t_strat=_t(jax.random.uniform(k_strat, (R, S))),
        noise0=_t(jax.random.normal(k_noise0, (R, S))),
        u_pdf=_t(jax.random.uniform(k_pdf, (R, S_imp))),
        noise1=_t(jax.random.normal(k_noise1, (R, S + S_imp)))))


def _pair(**kw):
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    sj = jscene(H=24, W=24, n_train=3, n_test=1)
    jt = JTrainer(_args(jparser(), **kw), sj)
    tt = Trainer(_args(config_parser(), **kw), make_synthetic_scene(H=24, W=24, n_train=3, n_test=1),
                 device="cpu", seed=1)
    load_jax_state(tt.state, None, to_np(jt.state.coarse), to_np(jt.state.fine))
    return sj, jt, tt


def _assert_nets_close(tt, jt, **tol):
    for which in ("coarse", "fine"):
        jparams = to_np(getattr(jt.state, which))
        for name, child in getattr(tt.state, which).named_children():
            layers = child if isinstance(child, torch.nn.ModuleList) else [child]
            jl = jparams[name] if isinstance(jparams[name], list) else [jparams[name]]
            for layer, p in zip(layers, jl):
                np.testing.assert_allclose(layer.weight.detach().numpy(), p["w"].T, **tol,
                                           err_msg=f"{which}.{name}")
                np.testing.assert_allclose(layer.bias.detach().numpy(), p["b"], **tol,
                                           err_msg=f"{which}.{name}.b")


@pytest.mark.parametrize("flags", [{}, {"use_gradient": True}, {"i_embed": -1, "i_embed_views": -1}],
                         ids=["nerf_positional", "nerf_gradient", "nerf_identity"])
def test_nerf_trainer_steps_match_jax(flags):
    """6 steps of the NeRF family from one state with the same batches and
    JAX's draws (jitter, sigma noise, importance draws; no TV: it belongs to
    the hash grid), JAX op by op: the loss each step, and the MLPs after
    Adam at the standing rtol 1e-4 / atol 1e-6."""
    from hashnerf_torch.train.adam import Adam

    sj, jt, tt = _pair(**flags)
    assert isinstance(tt.optimizer, Adam)
    R = SETTINGS["N_rand"]
    for step, b in enumerate(_batches(sj, 6, seed=0)):
        draws = _draws(jt, R, 8, 8)
        with jax.disable_jit():
            mj = jt.step({k: jnp.asarray(v) for k, v in b.items()})
        mt = tt.step({k: _t(v) for k, v in b.items()}, draws=draws)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4,
                                   err_msg=f"loss, step {step + 1}")
    assert tt.global_step == jt.global_step == 6
    _assert_nets_close(tt, jt, rtol=1e-4, atol=1e-6)


def test_nerf_jax_checkpoint_loads_and_trains_on(tmp_path):
    """A JAX checkpoint of the NeRF family (no table, optax.adam's state)
    after 4 JAX steps: parameters and Adam's moments and count load leaf by
    leaf, bit for bit; 2 more steps on each side stay together; the port's
    own checkpoint of it round-trips."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    sj, jt, _ = _pair(use_gradient=True)
    batches = list(_batches(sj, 6, seed=1))
    with jax.disable_jit():
        for b in batches[:4]:
            jt.step({k: jnp.asarray(v) for k, v in b.items()})
    jt.save(str(tmp_path / "000004.ckpt"))

    tt = Trainer(_args(config_parser(), use_gradient=True),
                 make_synthetic_scene(H=24, W=24, n_train=3, n_test=1), device="cpu", seed=2)
    assert tt.try_restore(str(tmp_path)) and tt.global_step == 4
    jadam = jt.opt_state[0]
    for which in ("coarse", "fine"):
        for name, child in getattr(tt.state, which).named_children():
            layers = child if isinstance(child, torch.nn.ModuleList) else [child]
            for i, layer in enumerate(layers):
                pick = lambda tree: (tree[name][i] if isinstance(tree[name], list) else tree[name])
                for attr, leaf in (("weight", "w"), ("bias", "b")):
                    T = (lambda a: a.T) if leaf == "w" else (lambda a: a)
                    p = getattr(layer, attr)
                    st = tt.optimizer.state[p]
                    np.testing.assert_array_equal(
                        p.detach().numpy(), T(np.asarray(pick(getattr(jt.state, which))[leaf])))
                    np.testing.assert_array_equal(
                        st["exp_avg"].numpy(), T(np.asarray(pick(getattr(jadam.mu, which))[leaf])))
                    np.testing.assert_array_equal(
                        st["exp_avg_sq"].numpy(), T(np.asarray(pick(getattr(jadam.nu, which))[leaf])))
                    assert float(st["step"]) == int(jadam.count) == 4
    R = SETTINGS["N_rand"]
    for b in batches[4:]:
        draws = _draws(jt, R, 8, 8)
        with jax.disable_jit():
            mj = jt.step({k: jnp.asarray(v) for k, v in b.items()})
        mt = tt.step({k: _t(v) for k, v in b.items()}, draws=draws)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
    _assert_nets_close(tt, jt, rtol=1e-4, atol=1e-6)

    tt.save(str(tmp_path / "port" / "000006.ckpt"))
    other = Trainer(_args(config_parser(), use_gradient=True),
                    make_synthetic_scene(H=24, W=24, n_train=3, n_test=1), device="cpu", seed=3)
    assert other.try_restore(str(tmp_path / "port")) and other.global_step == 6
    for (k, x), (_, y) in zip(tt.state.state_dict().items(), other.state.state_dict().items()):
        assert torch.equal(x, y), k
    # a hash-grid model refuses the NeRF checkpoint, loading nothing
    hashed = Trainer(_args(config_parser(), i_embed=1, i_embed_views=2, finest_res=64,
                           log2_hashmap_size=10),
                     make_synthetic_scene(H=24, W=24, n_train=3, n_test=1), device="cpu")
    with pytest.raises(ValueError):
        hashed.try_restore(str(tmp_path / "port"))
    with pytest.raises(ValueError):
        hashed.try_restore(str(tmp_path))
