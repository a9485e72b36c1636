"""Configurations that train from a ray pool (their argv leaves out
--no_batching; nerfbench/pool.py), on the CPU at tiny sizes: an image pool
and a column pool run `correct` through run_steps(pool=, offset=) in set-up,
the window and the checks; a window that crosses the pool's end reshuffles
and stays `correct`; planted pool faults make `correct` false; a pool-fed
configuration whose scene gives neither images nor columns is refused at
build. The cells of BENCHMARK.json, all under --no_batching, never hand
run_steps a pool, and compare as they did before pools."""
import os
import shutil

import pytest
import torch

from nerfbench import harness, pool, spec
from nerfbench.tests.tiny import tiny_config, tiny_traffic, write_tree

SEED = 2**31 + 26026
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
HERE = os.path.dirname(os.path.abspath(__file__))


def pooled(cfg: dict, **scene) -> dict:
    """The configuration without --no_batching, its scene changed by `scene`."""
    cfg["argv"] = [a for a in cfg["argv"] if a != "--no_batching"]
    cfg["scene"] = dict(cfg["scene"], **scene)
    return cfg


def run(name: str, cfg: dict, base: str = spec.HERE, seconds: float = 0.5, seed: int = SEED,
        tr=None):
    cell = spec.workload(BENCH, name)
    return harness.run_cell(cell, cfg, tr or tiny_traffic(cell["traffic"]),
                            spec.limits(name), seed, seconds, False, "cpu",
                            spec.metrics_for(BENCH, name, "per_layer"), base=base)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tree with the column-pool scene kind ring_pool, and a kind "bare"
    that gives neither images nor a pool."""
    base = write_tree(str(tmp_path_factory.mktemp("nb")), {}, {}, {})
    shutil.copy(os.path.join(HERE, "ring_pool_scene.py"),
                os.path.join(base, "scenes", "ring_pool.py"))
    with open(os.path.join(base, "scenes", "bare.py"), "w") as f:
        f.write("import torch\n\n\ndef make_scene(sp, device):\n"
                "    return {'H': sp['H'], 'W': sp['W'], 'near': 2.0, 'far': 6.0,\n"
                "            'bbox': torch.tensor([[-1.6] * 3, [1.6] * 3], device=device)}\n")
    return base


@pytest.fixture
def calls(monkeypatch):
    """Whether each Trainer.run_steps call was handed a pool."""
    import hashnerf_torch.train.driver as drv

    seen, inner = [], drv.Trainer.run_steps

    def spy(self, n_steps, block_size=0, precrop=False, pool=None, offset=0):
        seen.append(pool is not None)
        return inner(self, n_steps, block_size, precrop, pool, offset)

    monkeypatch.setattr(drv.Trainer, "run_steps", spy)
    return seen


@pytest.mark.parametrize("name", ["chair.train", "nerf.train"])
def test_an_image_pool_is_correct(name, calls):
    out = run(name, pooled(tiny_config(spec.workload(BENCH, name)["config"])))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and calls and all(calls)


def test_a_column_pool_scene_is_correct(tree, calls):
    out = run("chair.train", pooled(tiny_config("chair"), kind="ring_pool"), base=tree)
    assert out["correct"], out["compared"]
    assert all(calls)


@pytest.mark.parametrize("kind", ["ring", "ring_pool"])
def test_a_window_across_the_pools_end_reshuffles(kind, tree, monkeypatch):
    """One 10 x 10 view: 100 rows, 3 steps of 32 an epoch, i_print 4."""
    shuffled, inner = [], pool.PoolCursor.shuffle

    def spy(self):
        shuffled.append(self.trainer.global_step)
        inner(self)

    monkeypatch.setattr(pool.PoolCursor, "shuffle", spy)
    out = run("chair.train", pooled(tiny_config("chair"), kind=kind, H=10, W=10, n_train=1),
              base=tree)
    assert out["correct"], out["compared"]
    start = tiny_traffic("train_steady")["setup_steps"]
    inside = [g for g in shuffled if start <= g < start + out["attempted"]]
    assert len(inside) >= 2, (shuffled, out["attempted"])


def _cursor_stuck(monkeypatch):
    def run_steps(self, n, block_size):
        return self.trainer.run_steps(n, block_size=block_size, pool=self.pool, offset=self.offset)
    monkeypatch.setattr(pool.PoolCursor, "run", run_steps)


def _block_stuck(monkeypatch):
    """The device offset does not advance inside a block: each of its
    steps takes the block's first rows."""
    import hashnerf_torch.train.driver as drv

    inner = drv.Trainer._run_block

    def stuck(self, b, use_tv, occ_mode, precrop, keep, pool=None, offset=0):
        if pool is None:
            return inner(self, b, use_tv, occ_mode, precrop, keep)
        for _ in range(b):
            m = inner(self, 1, use_tv, occ_mode, precrop, keep, pool, offset)
        return m
    monkeypatch.setattr(drv.Trainer, "_run_block", stuck)


def _other_rows(monkeypatch):
    inner = pool.source_ids
    monkeypatch.setattr(pool, "source_ids", lambda rec, device: torch.roll(inner(rec, device), 32))


@pytest.mark.parametrize("fault", [_cursor_stuck, _block_stuck, _other_rows])
def test_pool_faults_fail(fault, monkeypatch):
    fault(monkeypatch)
    out = run("chair.train", pooled(tiny_config("chair")))
    assert not out["correct"]
    worst = max(out["compared"][k]["value"] / out["compared"][k]["limit"]
                for k in ("loss.trained", "move.trained"))
    assert worst > 10, out["compared"]


def test_a_pool_without_images_or_columns_is_refused(tree):
    with pytest.raises(ValueError, match='neither "images" nor "pool"'):
        harness.build(pooled(tiny_config("chair"), kind="bare"), SEED, "cpu", base=tree)


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_never_hand_run_steps_a_pool(name, calls):
    cfg = tiny_config(spec.workload(BENCH, name)["config"])
    assert "--no_batching" in cfg["argv"]
    out = run(name, cfg, seconds=1e-6)
    assert out["correct"]
    assert calls and not any(calls)


# `compared` of each cell's tiny copy (tests/tiny.py), one window span, one
# thread, seed 2**31 + 4242, as the harness before ray pools computed them
# (nerfbench at the commit before this file was added).
BEFORE_POOLS = {
    "chair.train": {"loss.start": 0.0, "grad.start": 1.0836591646881846e-09, "move.start": 0.0,
                    "loss.trained": 0.0, "grad.trained": 9.474574831580084e-09,
                    "move.trained": 3.359428172016616e-08},
    "flagship.train": {"loss.start": 0.0, "grad.start": 0.0, "move.start": 0.0,
                       "loss.trained": 0.0, "grad.trained": 0.0, "move.trained": 0.0},
    "chair.render": {"loss.start": 0.0, "grad.start": 1.0836591646881846e-09, "move.start": 0.0,
                     "rgb_mean_gap": 2.759474295156973e-10, "rgb_max_gap": 5.960464477539063e-08},
    "flagship.render": {"loss.start": 0.0, "grad.start": 0.0, "move.start": 0.0,
                        "rgb_mean_gap": 0.0, "rgb_max_gap": 0.0},
    "nerf.train": {"loss.start": 0.0, "grad.start": 0.0, "move.start": 0.0,
                   "loss.trained": 0.0, "grad.trained": 0.0, "move.trained": 0.0},
}


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_compare_as_before_pools(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = run(name, tiny_config(spec.workload(BENCH, name)["config"]), seconds=1e-6,
                  seed=2**31 + 4242)
    finally:
        torch.set_num_threads(threads)
    assert {k: v["value"] for k, v in out["compared"].items()} == BEFORE_POOLS[name]
