"""A model family and a scene kind brought to the harness as new files
alone: the port's classic NeRF at toy widths (toy_nerf.py, with its plain
reference) as families/toynerf.py, and the ring scene as scenes/ring2.py,
in a folder laid out as nerfbench/ is. Its train and render cells come
out correct on the CPU, and the planted faults make `correct` false."""
import copy
import os
import shutil

import pytest
import torch

from nerfbench import harness, spec
from nerfbench.tests.tiny import TINY_SCENE, tiny_traffic, write_tree

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 777
SETTINGS = {
    "N_rand": 32, "N_samples": 8, "N_importance": 8, "netdepth": 2, "netwidth": 16,
    "netdepth_fine": 2, "netwidth_fine": 16, "i_embed": -1, "i_embed_views": -1,
    "compute_dtype": "float32", "share_fine": False, "aabb_clip": False, "use_occupancy": False,
    "lrate": 5e-4, "lrate_decay": 250, "precrop_iters": 2, "precrop_frac": 0.5,
    "tv_loss_weight": 1e-6, "sparse_loss_weight": 1e-10, "white_bkgd": True, "use_viewdirs": True,
    "perturb": 1.0, "raw_noise_std": 0.0, "lindisp": False, "chunk": 64, "steps_per_dispatch": 2,
    "i_print": 4,
}
FLAGS = ("N_rand", "N_samples", "N_importance", "netdepth", "netwidth", "netdepth_fine",
         "netwidth_fine", "i_embed", "i_embed_views", "lrate", "lrate_decay", "precrop_iters",
         "precrop_frac", "chunk", "steps_per_dispatch", "i_print")
CONFIG = {
    "name": "toynerf", "family": "toynerf",
    "argv": ["--dataset_type", "blender", "--no_batching", "--use_viewdirs", "--white_bkgd",
             "--no_reload"] + [a for k in FLAGS for a in (f"--{k}", str(SETTINGS[k]))],
    "settings": SETTINGS,
    "scene": dict(TINY_SCENE, kind="ring2", bbox=1.6, near=2.0, far=6.0),
    "reduced": [],
}
# Limits of the toy cells' numbers. On the CPU, one thread, every number
# reads 0 on three seeds; the planted faults below read 1.1e-3 to 1.0 in
# loss.trained, grad.trained or move.trained, and 0.25 in rgb_max_gap.
LIMITS = {
    "toynerf.train": {"loss.start": 1e-6, "grad.start": 1e-5, "move.start": 1e-4,
                      "loss.trained": 1e-6, "grad.trained": 1e-5, "move.trained": 1e-4},
    "toynerf.render": {"loss.start": 1e-6, "grad.start": 1e-5, "move.start": 1e-4,
                       "rgb_mean_gap": 1e-6, "rgb_max_gap": 1e-5},
}
CELLS = {"toynerf.train": "train_steady", "toynerf.render": "render_spiral"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The folder, and a BENCHMARK.json holding the toy cells in the
    chair's metrics' lists."""
    base = write_tree(str(tmp_path_factory.mktemp("nb")), {"toynerf": CONFIG},
                      {k: tiny_traffic(k) for k in CELLS.values()}, LIMITS)
    shutil.copy(os.path.join(HERE, "toy_nerf.py"), os.path.join(base, "families", "toynerf.py"))
    shutil.copy(os.path.join(spec.HERE, "scenes", "ring.py"),
                os.path.join(base, "scenes", "ring2.py"))
    bench = copy.deepcopy(spec.load_benchmark())
    for cell, traffic in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "toynerf", "traffic": traffic,
                                   "chips": 1, "why": "test"})
        twin = "chair." + cell.split(".")[1]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if twin in m.get("workloads", []):
                m["workloads"].append(cell)
    return base, bench


def run_toy(tree, cell, trace=False, faults=None):
    base, bench = tree
    w = spec.workload(bench, cell)
    return harness.run_cell(w, spec.config(w["config"], base), spec.traffic(w["traffic"], base),
                            spec.limits(cell, base), SEED, 0.5, trace, "cpu",
                            spec.metrics_for(bench, cell, "per_layer"), base=base, faults=faults)


def test_the_family_and_the_scene_are_new_files_alone(tree):
    base, _ = tree
    fam = spec.family_of(CONFIG, base)
    scene = spec.scene_of(CONFIG, base)
    for mod, kind, name in ((fam, "families", "toynerf"), (scene, "scenes", "ring2")):
        path = os.path.abspath(mod.__file__)
        assert path == os.path.join(base, kind, name + ".py")
        assert not os.path.exists(os.path.join(spec.HERE, kind, name + ".py"))
    assert fam.grid(SETTINGS) is None and fam.step_groups(["a", "b"]) == {"net": ["a", "b"]}
    assert spec.family_of({}, base).__file__ == os.path.join(base, "families", "ngp.py")
    assert spec.scene_of({"scene": {}}, base).__file__ == os.path.join(base, "scenes", "ring.py")
    # D 2, W 16: 16*3 + 16*16 + 16*16 + 1*16 + 8*19 + 3*8
    assert fam.macs_per_point(SETTINGS) == 48 + 256 + 256 + 16 + 152 + 24 == 752


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_toy_family_is_correct(tree, cell):
    out = run_toy(tree, cell)
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == set(LIMITS[cell])


def test_a_traced_run_of_the_toy_family(tree):
    """No table: nothing is recorded for the encode's bytes."""
    seen = {}
    read = spec.read_metrics

    def keep_ctx(entries, ctx, base=spec.HERE):
        seen.update(ctx)
        return read(entries, ctx, base)

    spec.read_metrics = keep_ctx
    try:
        out = run_toy(tree, "toynerf.train", trace=True)
    finally:
        spec.read_metrics = read
    assert out["correct"], out["compared"]
    assert seen["encode"] is None and seen["family"].grid(SETTINGS) is None


def test_the_toy_family_fails_a_state_left_unchanged(tree):
    def frozen(trainer):
        trainer.optimizer.step = lambda closure=None: None
    out = run_toy(tree, "toynerf.train", faults={"program": frozen})
    assert not out["correct"]
    assert out["compared"]["move.trained"]["value"] > 0.5


def test_the_toy_family_fails_half_the_batch(tree, monkeypatch):
    import hashnerf_torch.train.driver as drv

    def half(x, y):
        n = x.shape[0] // 2
        return torch.mean((x[:n] - y[:n]) ** 2)

    out = run_toy(tree, "toynerf.train", faults={"program": lambda t: monkeypatch.setattr(
        drv, "img2mse", half)})
    assert not out["correct"]
    assert out["compared"]["loss.trained"]["value"] > out["compared"]["loss.trained"]["limit"]


def test_the_toy_family_fails_an_altered_answer(tree):
    def alter(frames):
        for _, rgb in frames:
            rgb[0, 0, 0] += 0.25
    out = run_toy(tree, "toynerf.render", faults={"frames": alter})
    assert not out["correct"]
    assert abs(out["compared"]["rgb_max_gap"]["value"] - 0.25) < 1e-3
