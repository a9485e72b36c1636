"""The port's utils (ROADMAP A9.3) against the JAX package's on the CPU:
the HASHNERF_DEBUG NaN/Inf scan (utils/debug.py) on the same trees, and
on a render's outputs with a NaN planted; the torch.profiler trace
(utils/profiling.py); and bench_scaling's
Trainer against the JAX tool's (ROADMAP §C)."""
import collections
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

Pair = collections.namedtuple("Pair", ["x", "y"])


def _tree(rng, nan: bool):
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    c = rng.normal(size=(2, 2)).astype(np.float32)
    if nan:
        a[0, 1] = np.nan
        a[2, 2] = np.inf
        c[1, 0] = -np.inf
    return {"zeta": a, "alpha": [b, Pair(x=c, y=np.arange(4))], "none": None,
            "scalar": np.float32(np.nan) if nan else np.float32(1.0)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_torch_tree(v) for v in tree))
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


@pytest.mark.parametrize("nan", [True, False], ids=["nan", "clean"])
def test_check_finite_matches_jax(capsys, nan):
    """The same offenders in the same order (dict keys sorted, as
    jax.tree_util flattens them), spelt as JAX spells their paths, from
    tensors as from numpy; integer leaves and None skipped."""
    from hashnerf_tpu.utils.debug import check_finite as jcheck
    from hashnerf_torch.utils.debug import check_finite

    tree = _tree(np.random.default_rng(0), nan)
    want_ok = jcheck(tree, where="w:")
    want = capsys.readouterr().out
    got_ok = check_finite(_torch_tree(tree), where="w:")
    got = capsys.readouterr().out
    assert got == want and got_ok == want_ok == (not nan)
    if nan:
        assert got.count("! [Numerical Error]") == 3 and "w:['zeta'] contains 2 nan/inf of 12" in got
    assert check_finite(tree, where="w:") == want_ok
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("value", ["1", "0", "", "false", "yes"])
def test_debug_enabled_matches_jax(monkeypatch, value):
    from hashnerf_tpu.utils.debug import debug_enabled as jenabled
    from hashnerf_torch.utils.debug import debug_enabled

    monkeypatch.setenv("HASHNERF_DEBUG", value)
    assert debug_enabled() == jenabled()


def _nan_render():
    """render of a 4 x 4 view whose query gives NaN sigma at x > 0."""
    from hashnerf_torch.render.renderer import RenderConfig, render

    def query(state, pts, viewdirs, bbox, fine=False):
        raw = torch.ones(pts.shape[:-1] + (4,))
        raw[..., 3] = torch.where(pts[..., 0] > 0, torch.nan, 1.0)
        return raw

    K = np.array([[4.0, 0, 2.0], [0, 4.0, 2.0], [0, 0, 1]])
    c2w = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4]])
    bbox = torch.tensor([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]])
    cfg = RenderConfig(N_samples=8, perturb=False, use_viewdirs=False)
    rgb, depth, acc, extras = render(None, query, 4, 4, K, bbox, cfg, c2w=c2w, near=2.0, far=6.0)
    return {"rgb_map": rgb, "depth_map": depth, "acc_map": acc, **extras}


def test_render_scans_its_outputs_when_debug_is_on(capsys, monkeypatch):
    """HASHNERF_DEBUG=1: render prints JAX's message for each output map
    that holds a NaN (the planted sigma), as check_finite of the JAX
    package prints it for the same maps; off, it prints nothing."""
    from hashnerf_tpu.utils.debug import check_finite as jcheck

    monkeypatch.setenv("HASHNERF_DEBUG", "0")
    _nan_render()
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("HASHNERF_DEBUG", "1")
    out = _nan_render()
    got = capsys.readouterr().out
    assert "! [Numerical Error] render:['rgb_map'] contains" in got
    assert not jcheck({k: v.numpy() for k, v in out.items()}, where="render:")
    assert capsys.readouterr().out == got


def test_device_trace_writes_an_annotated_trace(tmp_path):
    """device_trace writes a Chrome trace of the block (CPU activity here)
    holding the region annotate named."""
    from hashnerf_torch.utils.profiling import annotate, device_trace

    with device_trace(str(tmp_path / "trace")):
        with annotate("hashnerf_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "hashnerf_region" for e in events)


def test_bench_scaling_trainer_is_the_jax_tools():
    """bench_scaling.measure's Trainer (timing_args) is the one the JAX
    tool's measure builds from _tiny_timing_args (4096 rays, 16 + 32
    samples): every field the two model and render configs share, the
    learning rate and its decay, and no TV."""
    import dataclasses

    from hashnerf_tpu.data.synthetic import make_synthetic_scene as jscene
    from hashnerf_tpu.tools.bench_scaling import _tiny_timing_args
    from hashnerf_tpu.train.config import config_parser
    from hashnerf_tpu.train.driver import Trainer as JTrainer
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.tools.bench_scaling import timing_args
    from hashnerf_torch.train.driver import Trainer

    jargs = _tiny_timing_args(config_parser, 4096)
    jargs.N_samples, jargs.N_importance = 16, 32  # what measure sets
    jt = JTrainer(jargs, jscene(H=64, W=64, n_train=4, n_test=1))
    args = timing_args(4096)
    t = Trainer(args, make_synthetic_scene(H=64, W=64, n_train=4, n_test=1), device="cpu")

    def fields(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}

    for mine, theirs in ((t.model_cfg, jt.model_cfg), (t.render_cfg, jt.render_cfg)):
        a, b = fields(mine), fields(theirs)
        assert a.keys() <= b.keys()
        for k in a:
            va, vb = a[k], b[k]
            if dataclasses.is_dataclass(va):
                assert dataclasses.asdict(va) == dataclasses.asdict(vb), k
            else:
                assert va == vb, k
    assert t.model_cfg.hash_grid.finest_resolution == 128
    assert t.model_cfg.hash_grid.log2_hashmap_size == 15
    assert (args.lrate, args.lrate_decay, args.N_rand) == (jargs.lrate, jargs.lrate_decay, 4096)
    assert args.lrate == 5e-4 and args.tv_loss_weight == 0.0
