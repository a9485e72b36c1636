"""The --compute_dtype names other than bfloat16 and float16 (ROADMAP A7.4)
against the JAX package on the CPU: NeRFSmall, NeRF and NeRFGradient at
compute_dtype "float32" and "float64" (and their aliases) against
apply_nerf_small, apply_nerf and apply_nerf_gradient at jnp.dtype of the
same name, forward and gradients; the float8 types torch has, forward; the
names JAX refuses; and a Trainer step at --compute_dtype float32.

Tolerances: float32 outputs at rtol 1e-5 / atol 1e-6 and gradients at
rtol 1e-5 / atol 1e-5 (tests/test_torch_nerf.py's: sums of a few hundred
products in other orders); the float8 forward bit for bit."""
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from test_torch_packed import _mlp_params

to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
F32_NAMES = ["float32", "f4", "single", "float64", "double"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _nets(model, name):
    """(port net, JAX apply, JAX params, input width, output width)."""
    from hashnerf_tpu.models import nerf as jn
    from hashnerf_torch.convert import _load_mlp
    from hashnerf_torch.models import nerf as tn

    rng = np.random.default_rng(4)
    if model == "nerf_small":
        cfg = tn.NeRFSmallConfig(input_ch=32, input_ch_views=16, compute_dtype=name)
        params = _mlp_params(rng, cfg)
        jcfg = jn.NeRFSmallConfig(input_ch=32, input_ch_views=16)
        net, apply, n_in, n_out = tn.NeRFSmall(cfg), jn.apply_nerf_small, 48, 4
    else:
        kw = dict(D=6, W=32, input_ch=21, input_ch_views=9, output_ch=5, skips=(4,),
                  use_viewdirs=True)
        jcfg = jn.NeRFConfig(**kw)
        grad = model == "nerf_gradient"
        init, apply = ((jn.init_nerf_gradient, jn.apply_nerf_gradient) if grad
                       else (jn.init_nerf, jn.apply_nerf))
        params = to_np(init(jax.random.PRNGKey(3), jcfg))
        net = (tn.NeRFGradient if grad else tn.NeRF)(tn.NeRFConfig(**kw, compute_dtype=name))
        n_in, n_out = 30, 7 if grad else 4
    with torch.no_grad():
        _load_mlp(net, params)
    return net, (lambda p, x: apply(p, x, jcfg, jnp.dtype(name))), params, n_in, n_out


def _layer_grads(net, jgrads):
    """(port layer, JAX gradient dict) pairs, by the port's child names
    (JAX's keys)."""
    for name, child in net.named_children():
        layers = child if isinstance(child, torch.nn.ModuleList) else [child]
        jl = jgrads[name] if isinstance(jgrads[name], list) else [jgrads[name]]
        assert len(layers) == len(jl), name
        yield from zip(layers, jl)


@pytest.mark.parametrize("model", ["nerf_small", "nerf", "nerf_gradient"])
@pytest.mark.parametrize("name", F32_NAMES)
def test_float32_names_match_jax(model, name):
    """Each name runs the float32 product: as JAX's DEFAULT-precision dot at
    that dtype on the CPU (float64 too: JAX without x64 runs it in
    float32), and as the port's compute_dtype None, bit for bit."""
    net, apply, params, n_in, n_out = _nets(model, name)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, n_in)).astype(np.float32)
    probe = rng.normal(size=(300, n_out)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX's float64 -> float32 note
        yj = apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
        gp, gx = jax.grad(lambda p, x_: jnp.sum(apply(p, x_) * probe), argnums=(0, 1))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    assert yj.dtype == jnp.float32
    xt = _t(x).requires_grad_(True)
    yt = net(xt)
    (yt * _t(probe)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    for layer, g in _layer_grads(net, to_np(gp)):
        np.testing.assert_allclose(layer.weight.grad.numpy(), g["w"].T, rtol=1e-5, atol=1e-5)
        if layer.bias is not None:
            np.testing.assert_allclose(layer.bias.grad.numpy(), g["b"], rtol=1e-5, atol=1e-5)
    plain, *_ = _nets(model, None)
    with torch.no_grad():
        assert torch.equal(plain(_t(x)), yt.detach())


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_float8_names_match_jax(name):
    """A float8 type torch has rounds the operands as ml_dtypes does:
    NeRFSmall's forward equals JAX's bit for bit."""
    net, apply, params, n_in, _ = _nets("nerf_small", name)
    x = np.random.default_rng(2).normal(size=(300, n_in)).astype(np.float32)
    yj = apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_array_equal(net(_t(x)).numpy(), np.asarray(yj))


@pytest.mark.parametrize("name,err", [("foo", TypeError), ("Float32", TypeError),
                                      ("float128", TypeError), ("int32", ValueError),
                                      ("float8_e3m4", ValueError)])
def test_other_names_raise(name, err):
    """Names numpy cannot parse raise TypeError, as jnp.dtype does; float128
    TypeError, as JAX's astype does; a type that is not floating, or one
    torch cannot represent, ValueError."""
    from hashnerf_torch.models.nerf import compute_dtype_of

    if name in ("foo", "Float32"):
        with pytest.raises(TypeError):
            jnp.dtype(name)
    with pytest.raises(err):
        compute_dtype_of(name)


def test_float32_trainer_step_is_the_default_step():
    """A Trainer at --compute_dtype float32 takes the step of the default
    (None) Trainer, bit for bit: loss and every parameter after it."""
    import os

    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer

    smoke = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "synthetic_smoke.txt")
    sc = make_synthetic_scene(H=16, W=16, n_train=2, n_test=1)
    out = []
    for extra in ([], ["--compute_dtype", "float32"]):
        args = parse_args(["--config", smoke, "--N_rand", "64", "--N_samples", "8",
                           "--N_importance", "8", "--device", "cpu", *extra])
        t = Trainer(args, sc, device="cpu", seed=2)
        loss = float(t.step(t.sample_batch(False))["loss"])
        out.append((loss, [p.detach().clone() for p in t.state.parameters()]))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
