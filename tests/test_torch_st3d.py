"""The st3d / OmniNeRF panorama path in the port against the JAX package on
the CPU: equirect_directions, the numpy Laplacian (against cv2.Laplacian and
JAX's _laplacian_gradient), 16-bit PNGs (against imageio), load_st3d_data on
the 512 x 1024 set of tests/conftest.py::st3d_dir, the data tool
file for file, the loss's depth and gradient terms, pool steps of the hash
model and of OmniNeRF's positional NeRFGradient against JAX's
run_steps_pool, and the CLI run of tests/test_cli.py::test_cli_st3d_train
(with --st3d_eval_views 2, and 1, where the port writes no GIF).

The set's rays are loaded once for the module (about 9 s): the CLI runs take
them from there."""
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


@pytest.fixture(scope="module")
def port_rays(st3d_dir):
    from hashnerf_torch.data.st3d import load_st3d_data

    return load_st3d_data(st3d_dir, stage=0)


# --------------------------------------------------------------------------- #
# Directions, the Laplacian, 16-bit PNGs
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("hw", [(512, 1024), (7, 10)])
def test_equirect_directions_match_jax(hw):
    from hashnerf_tpu.ops.rays import equirect_directions as jdirs
    from hashnerf_torch.ops.rays import equirect_directions

    got = equirect_directions(*hw)
    assert got.dtype == np.float32 and got.shape == hw + (3,)
    np.testing.assert_array_equal(got, jdirs(*hw))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("shape", [(512, 1024, 3), (5, 7, 3), (1, 4, 3)])
def test_laplacian_matches_cv2_and_jax(shape):
    """Bit for bit: cv2.Laplacian (ksize 1, BORDER_REFLECT_101) and the JAX
    loader's scaled gradient target."""
    import cv2
    from hashnerf_tpu.data.st3d import _laplacian_gradient
    from hashnerf_torch.data.st3d import laplacian, laplacian_gradient

    rgb = np.random.default_rng(0).integers(0, 255, shape) / 255.0
    np.testing.assert_array_equal(laplacian(rgb), cv2.Laplacian(rgb, cv2.CV_64F))
    np.testing.assert_array_equal(laplacian_gradient(rgb), _laplacian_gradient(rgb))


def test_16bit_png_matches_imageio(st3d_dir, tmp_path):
    import imageio.v2 as imageio
    from hashnerf_torch.utils.png import read_png, write_png

    d = os.path.join(st3d_dir, "scene01_d.png")  # written by imageio
    got = read_png(d)
    assert got.dtype == np.uint16 and got.shape == (512, 1024)
    np.testing.assert_array_equal(got, imageio.imread(d))
    # and back: the port's 16-bit file read by imageio, gray and RGB
    rng = np.random.default_rng(1)
    for shape in ((33, 45), (9, 11, 3)):
        a = rng.integers(0, 65536, shape).astype(np.uint16)
        write_png(str(tmp_path / "a.png"), a)
        np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), a)
        if len(shape) == 2:
            np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), a)


# --------------------------------------------------------------------------- #
# The loader and the data tool
# --------------------------------------------------------------------------- #

def test_load_st3d_matches_jax(st3d_dir, port_rays):
    """Every array of both bundles, bit for bit."""
    from hashnerf_tpu.data.st3d import load_st3d_data as jload

    tr, te, H, W = port_rays
    jtr, jte, jH, jW = jload(st3d_dir, stage=0)
    assert (H, W) == (jH, jW) == (512, 1024)
    for name in ("o", "d", "rgb", "depth", "g"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jtr, name), err_msg=f"train {name}")
    del jtr
    for name in ("o", "d", "rgb", "depth"):
        np.testing.assert_array_equal(getattr(te, name), getattr(jte, name), err_msg=f"test {name}")
    assert te.g is None and jte.g is None
    assert te.rgb.shape[0] == 11 * H * W and tr.o.dtype == np.float32


def test_shuffled_matches_jax(port_rays):
    from hashnerf_tpu.data.scene import RayBundle as JBundle

    tr = port_rays[0]
    part = type(tr)(tr.o[:1000], tr.d[:1000], tr.rgb[:1000], tr.depth[:1000], tr.g[:1000])
    got = part.shuffled(np.random.default_rng(0))
    want = JBundle(part.o, part.d, part.rgb, part.depth, part.g).shuffled(np.random.default_rng(0))
    for name in ("o", "d", "rgb", "depth", "g"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_stage_and_exr_refusals(st3d_dir, tmp_path, monkeypatch):
    from hashnerf_torch.data import st3d
    from hashnerf_torch.train.config import check_supported, parse_args

    with pytest.raises(NotImplementedError, match="unimplemented upstream"):
        st3d.load_st3d_data(st3d_dir, stage=1)
    mp3d = str(tmp_path / "mp3d" / "scene01")
    args = parse_args(["--dataset_type", "st3d", "--datadir", mp3d])
    assert st3d.needs_exr(mp3d) and not st3d.needs_exr(st3d_dir)
    check_supported(args)  # cv2 is here
    monkeypatch.setattr(st3d, "cv2_or_none", lambda: None)
    with pytest.raises(NotImplementedError, match="A6"):
        check_supported(args)
    with pytest.raises(NotImplementedError, match="A6"):
        st3d.load_st3d_data(mp3d)


def test_data_tool_matches_jax_file_for_file(tmp_path):
    """A 32 x 64 panorama, 6 train and 3 test views from both tools: the
    same files, each decoding to the same pixels, the same positions."""
    import imageio.v2 as imageio
    from hashnerf_tpu.tools.generate_equirect_data import generate as jgen
    from hashnerf_torch.tools.generate_equirect_data import generate
    from hashnerf_torch.utils.png import read_png

    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 255, (32, 64, 3)).astype(np.uint8)
    d = (rng.uniform(0.3, 1.0, (32, 64)) * 65535).astype(np.uint16)
    dirs = {}
    for who in ("jax", "port"):
        root = tmp_path / who / "pano"
        os.makedirs(root)
        imageio.imwrite(root / "pano_rgb.png", rgb)
        imageio.imwrite(root / "pano_d.png", d)
        (jgen if who == "jax" else generate)(str(root), n_train=6, n_test=3, radius=0.1, seed=2)
        dirs[who] = root
    files = {w: sorted(os.path.relpath(os.path.join(a, f), r) for a, _, fs in os.walk(r) for f in fs)
             for w, r in dirs.items()}
    assert files["jax"] == files["port"] and len(files["port"]) == 2 + 6 + 3 + 2
    for f in files["port"]:
        a, b = dirs["jax"] / f, dirs["port"] / f
        if f.endswith(".txt"):
            assert a.read_text() == b.read_text(), f
        else:
            np.testing.assert_array_equal(read_png(str(b)), imageio.imread(a), err_msg=f)
    masks = [read_png(str(dirs["port"] / "rm_occluded" / f"mask_{i}.png")) for i in range(6)]
    assert all(set(np.unique(m)) <= {0, 255} for m in masks) and 0 < np.mean(masks) < 255


# --------------------------------------------------------------------------- #
# The loss and pool steps
# --------------------------------------------------------------------------- #

HASH = dict(i_embed=1, i_embed_views=2, finest_res=64, log2_hashmap_size=10)
OMNI = dict(i_embed=0, i_embed_views=0, multires=6, multires_views=3, netdepth=6, netwidth=32,
            netdepth_fine=6, netwidth_fine=32)
SETTINGS = dict(N_rand=32, N_samples=8, N_importance=8, lrate=5e-3, lrate_decay=10,
                use_viewdirs=True, perturb=1.0, raw_noise_std=1.0, dataset_type="st3d")


def _args(parser, **kw):
    args = parser.parse_args([])
    for k, v in {**SETTINGS, **kw}.items():
        setattr(args, k, v)
    return args


def _pair(model, **kw):
    """A JAX Trainer set up as run_nerf.py's main_st3d sets it up (near 0,
    far 2, bbox [-2, 2]^3) and a port Trainer on st3d_scene with its state."""
    from hashnerf_tpu.train.config import config_parser as jparser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.data.st3d import st3d_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    flags = {**model, **kw}
    jt = JTrainer(_args(jparser(), **flags), scene=None)
    jt.near, jt.far = 0.0, 2.0
    jt.bbox = jnp.array([[-2.0] * 3, [2.0] * 3], jnp.float32)
    jt._train_step = jt._build_train_step()
    if jt.state.hash_table is not None:
        # U(-1, 1) tables (tests/test_torch_train.py says why)
        jt.state = jt.state._replace(hash_table=jt.state.hash_table * 1e4)
    tt = Trainer(_args(config_parser(), **flags), st3d_scene(512, 1024), device="cpu", seed=1)
    table = None if jt.state.hash_table is None else np.asarray(jt.state.hash_table)
    load_jax_state(tt.state, table, to_np(jt.state.coarse), to_np(jt.state.fine))
    np.testing.assert_array_equal(tt.bbox.numpy(), np.asarray(jt.bbox))
    assert (tt.near, tt.far) == (jt.near, jt.far)
    return jt, tt


def _render_draws(k_render, R, S, S_imp):
    from hashnerf_torch.render.renderer import RenderDraws

    k_strat, k_noise0, k_pdf, k_noise1 = jax.random.split(k_render, 4)
    return RenderDraws(t_strat=_t(jax.random.uniform(k_strat, (R, S))),
                       noise0=_t(jax.random.normal(k_noise0, (R, S))),
                       u_pdf=_t(jax.random.uniform(k_pdf, (R, S_imp))),
                       noise1=_t(jax.random.normal(k_noise1, (R, S + S_imp))))


def _step_draws(k_step, hashed: bool):
    """The draws of one JAX train step from its key: the render's and, on
    the hash grid, TV's."""
    from hashnerf_torch.train.driver import TrainDraws
    from hashnerf_torch.train.losses import tv_level_geometry

    k_render, k_tv = jax.random.split(k_step)
    mv = None
    if hashed:
        L = 16
        keys = jax.random.split(k_tv, L)
        mv = _t(np.stack([np.asarray(jax.random.randint(keys[l], (3,), 0, r - c))
                          for l, (r, c) in enumerate(tv_level_geometry(16, 64, l, L)
                                                     for l in range(L))]))
    return TrainDraws(render=_render_draws(k_render, SETTINGS["N_rand"], 8, 8), tv_min_vertices=mv)


def _columns(tr, rows, use_depth, use_gradient):
    return {"rays_o": tr.o[rows], "rays_d": tr.d[rows], "target": tr.rgb[rows],
            "target_depth": tr.depth[rows] if use_depth else None,
            "target_grad": tr.g[rows] if use_gradient else None}


@pytest.mark.parametrize("model,use_depth,use_gradient", [
    (OMNI, True, True), (OMNI, True, False), (OMNI, False, True), (HASH, True, True),
], ids=["omni_depth_grad", "omni_depth", "omni_grad", "hash_depth_grad_vestigial"])
def test_loss_fn_depth_and_gradient_terms_match_jax(port_rays, model, use_depth, use_gradient):
    """make_loss_fn on one pool batch from one state with JAX's draws: the
    loss and every parameter's gradient (rtol 1e-4 / atol 1e-6). The depth
    term is the L1 of depth_map and depth0; the gradient term the MSE of
    grad_map, which NeRFGradient's 7 channels give and the hash grid's
    NeRFSmall does not (its use_gradient is vestigial, as in JAX)."""
    from hashnerf_tpu.train.driver import make_loss_fn as jmake
    from hashnerf_torch.train.driver import make_loss_fn

    grad_head = model is OMNI and use_gradient
    jt, tt = _pair(model, use_depth=use_depth, use_gradient=use_gradient)
    tr = port_rays[0]
    rows = np.arange(0, 32 * 997, 997)
    cols = _columns(tr, rows, use_depth, use_gradient)
    batch = {k: v for k, v in cols.items() if v is not None}
    batch["near"], batch["far"] = np.zeros(32, np.float32), np.full(32, 2.0, np.float32)
    batch["viewdirs"] = batch["rays_d"] / np.linalg.norm(batch["rays_d"], axis=-1, keepdims=True)
    key = jax.random.PRNGKey(7)
    jloss = jmake(jt.args, jt.render_cfg, jt.query_fn, jt.bbox, jt.model_cfg.hash_grid)
    with jax.disable_jit():
        (lj, (pj, _)), gj = jax.value_and_grad(jloss, has_aux=True)(
            jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, key, jnp.float32(1e-6))
    loss_fn = make_loss_fn(tt.args, tt.render_cfg, tt.bbox, tt.model_cfg)
    lt, (pt, _) = loss_fn(tt.state, {k: _t(v) for k, v in batch.items()}, 1e-6,
                          draws=_step_draws(key, model is HASH))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    np.testing.assert_allclose(float(pt), float(pj), rtol=1e-4)
    # the terms are there: the loss without them is smaller
    plain = make_loss_fn(type(tt.args)(**{**vars(tt.args), "use_depth": False,
                                          "use_gradient": False}),
                         tt.render_cfg, tt.bbox, tt.model_cfg)
    with torch.no_grad():
        l0, _ = plain(tt.state, {k: _t(v) for k, v in batch.items()}, 1e-6,
                      draws=_step_draws(key, model is HASH))
    assert (float(lt.detach()) > float(l0) + 1e-3) == (use_depth or grad_head)
    jg = to_np(gj)
    for which in ("coarse", "fine"):
        jparams = jg._asdict()[which]
        for name, child in getattr(tt.state, which).named_children():
            layers = child if isinstance(child, torch.nn.ModuleList) else [child]
            jl = jparams[name] if isinstance(jparams[name], list) else [jparams[name]]
            for layer, p in zip(layers, jl):
                np.testing.assert_allclose(layer.weight.grad.numpy(), p["w"].T, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{which}.{name}")
    if model is HASH:
        np.testing.assert_allclose(tt.state.hash_table.grad.numpy(), np.asarray(jg.hash_table),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("model", [HASH, OMNI], ids=["st3d_hash", "omninerf"])
def test_pool_steps_match_jax(port_rays, model):
    """4 steps on the shuffled pool of the loader's rays (every 256th ray of
    the set, shuffled by np.random.default_rng(0)'s permutation, as
    main_st3d shuffles): JAX's run_steps_pool block against the port's
    eager pool steps with JAX's draws (its run_steps on the pool equals
    those steps: test_column_pool_run_steps_equal_pool_steps). Both
    supervise depth and gradient (vestigial on the hash grid, whose pool
    carries the column all the same). Loss each step, then every
    parameter, at the standing rtol 1e-4 / atol 1e-6."""
    from hashnerf_torch.train.driver import POOL_LAYOUTS

    jt, tt = _pair(model, use_depth=True, use_gradient=True)
    tr = port_rays[0]
    sub = np.arange(0, tr.o.shape[0], 256)
    perm = np.random.default_rng(0).permutation(len(sub))
    cols = _columns(tr, sub, True, True)
    pool = tt.build_column_pool(cols)
    tt.shuffle_pool(pool, perm)
    assert POOL_LAYOUTS[pool.shape[1]] == ("rays_o", "rays_d", "target", "target_depth",
                                           "target_grad")
    assert pool.shape == (len(sub), 13)
    R, n = SETTINGS["N_rand"], 4
    jpool = {k: jnp.asarray(v[perm[:n * R]]) for k, v in cols.items()}

    keys = jax.random.split(jax.random.split(jt.key)[1], n)
    with jax.disable_jit():
        mj = jt.run_steps_pool(jpool, 0, n, block_size=n)
    for k in range(n):
        mt = tt.step(tt.sample_pool(pool, k * R, R), draws=_step_draws(keys[k], model is HASH))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(mt["psnr"]), float(mj["psnr"]), rtol=1e-4)
    assert tt.global_step == jt.global_step == n
    for which in ("coarse", "fine"):
        jparams = to_np(getattr(jt.state, which))
        for name, child in getattr(tt.state, which).named_children():
            layers = child if isinstance(child, torch.nn.ModuleList) else [child]
            jl = jparams[name] if isinstance(jparams[name], list) else [jparams[name]]
            for layer, p in zip(layers, jl):
                np.testing.assert_allclose(layer.weight.detach().numpy(), p["w"].T, rtol=1e-4,
                                           atol=1e-6, err_msg=f"{which}.{name}")
    if model is HASH:
        np.testing.assert_allclose(tt.state.hash_table.detach().numpy(),
                                   np.asarray(jt.state.hash_table), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("model", [HASH, OMNI], ids=["st3d_hash", "omninerf"])
def test_column_pool_run_steps_equal_pool_steps(port_rays, model):
    """run_steps on a column pool (blocks of 4 from row 64, the body the
    card captures) against as many sample_pool steps, bit for bit; each
    batch holds its depth and gradient columns."""
    from hashnerf_torch.data.st3d import st3d_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    tr = port_rays[0]
    cols = _columns(tr, np.arange(0, 4096), True, True)
    a, b = (Trainer(_args(config_parser(), use_depth=True, use_gradient=True, **model),
                    st3d_scene(512, 1024), device="cpu", seed=3) for _ in range(2))
    pool = a.build_column_pool(cols)
    assert torch.equal(pool, b.build_column_pool(cols))
    batch = b.sample_pool(pool, 64, 32)
    np.testing.assert_array_equal(batch["target_depth"].numpy(), tr.depth[64:96])
    np.testing.assert_array_equal(batch["target_grad"].numpy(), tr.g[64:96])
    ma = a.run_steps(8, block_size=4, pool=pool, offset=64)
    for k in range(8):
        mb = b.step(b.sample_pool(pool, 64 + 32 * k, 32))
    assert torch.equal(ma["loss"], mb["loss"])
    for (k, x), (_, y) in zip(a.state.state_dict().items(), b.state.state_dict().items()):
        assert torch.equal(x, y), k


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #

CLI = ["--expname", "st3d_smoke", "--dataset_type", "st3d", "--i_embed", "0", "--i_embed_views", "0",
       "--use_viewdirs", "--use_depth", "--use_gradient", "--netdepth", "2", "--netwidth", "32",
       "--N_rand", "256", "--N_samples", "8", "--N_importance", "0", "--N_iters", "4",
       "--i_print", "2", "--i_weights", "4", "--i_testset", "4", "--i_video", "100000",
       "--chunk", "8192", "--device", "cpu"]


@pytest.mark.parametrize("views", [2, 1])
def test_st3d_cli(st3d_dir, port_rays, tmp_path, monkeypatch, views):
    """tests/test_cli.py::test_cli_st3d_train's run in the port: a
    checkpoint, statistics.txt with a finite PSNR of the ground-truth view
    and video2.gif of the other view there and back. With one view there is
    none: statistics.txt and no GIF (the JAX package crashes there)."""
    from hashnerf_torch.data import st3d
    from hashnerf_torch.run_nerf import main

    monkeypatch.setattr(st3d, "load_st3d_data", lambda d, s: port_rays)
    trainer = main(CLI + ["--basedir", str(tmp_path), "--datadir", st3d_dir,
                          "--st3d_eval_views", str(views)])
    assert trainer.global_step == 4 and [h[0] for h in trainer.history] == [2, 4]
    assert all(np.isfinite(h[1]) for h in trainer.history)
    (exp,) = os.listdir(tmp_path)
    files = os.listdir(tmp_path / exp)
    assert "000004.ckpt" in files and "testset_000004" in files
    testset = tmp_path / exp / "testset_000004"
    stats = (testset / "statistics.txt").read_text()
    assert np.isfinite(float(stats.split("psnr:")[1].strip()))
    assert ("video2.gif" in os.listdir(testset)) == (views > 1)
    if views > 1:
        data = (testset / "video2.gif").read_bytes()
        assert data[:6] == b"GIF89a" and data.count(b"\x2c\x00\x00\x00\x00") >= 2
