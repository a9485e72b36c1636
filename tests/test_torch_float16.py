"""float16 MLP compute (--compute_dtype float16) against the JAX package on
the CPU: a NeRFSmall forward and backward, and 8 Trainer steps, at the
tolerances of the bfloat16 tests (test_torch_packed.py,
test_torch_packed_train.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

torch.set_num_threads(2)

from test_torch_jax_ckpt import SETTINGS, _args, _batches, _jax_draws, _t
from test_torch_packed import _mlp_params


def test_nerf_small_float16_matches_jax():
    from hashnerf_tpu.models.nerf import NeRFSmallConfig as JCfg, apply_nerf_small
    from hashnerf_torch.convert import _load_mlp
    from hashnerf_torch.models.nerf import NeRFSmall, NeRFSmallConfig

    rng = np.random.default_rng(9)
    cfg = NeRFSmallConfig(input_ch=32, input_ch_views=16, compute_dtype="float16")
    params = _mlp_params(rng, cfg)
    x = rng.normal(size=(500, 48)).astype(np.float32)
    probe = rng.normal(size=(500, 4)).astype(np.float32)
    jcfg = JCfg(input_ch=32, input_ch_views=16)
    f = lambda p, x_: jnp.sum(apply_nerf_small(p, x_, jcfg, jnp.float16) * probe)
    yj = apply_nerf_small(params, jnp.asarray(x), jcfg, jnp.float16)
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
    # the rounding is float16's, not bfloat16's
    bf = NeRFSmall(NeRFSmallConfig(input_ch=32, input_ch_views=16, compute_dtype="bfloat16"))
    with torch.no_grad():
        _load_mlp(bf, params)
        assert not torch.equal(bf(_t(x)), yt.detach())


def test_float16_trainer_steps_match_jax():
    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    sj = jscene(H=24, W=24, n_train=3, n_test=1)
    jt = JTrainer(_args(jparser(), compute_dtype="float16"), sj)
    jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    tt = Trainer(_args(config_parser(), compute_dtype="float16"),
                 make_synthetic_scene(H=24, W=24, n_train=3, n_test=1), device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_state(tt.state, np.asarray(jt.state.hash_table), to_np(jt.state.coarse),
                   to_np(jt.state.fine))
    init = [p.detach().clone() for p in tt.state.parameters()]
    for step, b in enumerate(_batches(sj, 8, seed=0)):
        draws = _jax_draws(jt, SETTINGS["N_rand"])
        with jax.disable_jit():
            mj = jt.step({k: jnp.asarray(v) for k, v in b.items()})
        mt = tt.step({k: _t(v) for k, v in b.items()}, draws=draws)
        # float16 products summed in other orders: the bf16 step's 1e-3
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-3,
                                   err_msg=f"loss, step {step + 1}")
    assert tt.global_step == jt.global_step == 8
    # RAdam moved every parameter from step 6 on
    assert all(not torch.equal(a, p) for a, p in zip(init, tt.state.parameters()))
