"""Runs of the harness on the CPU at tiny sizes: every cell of
BENCHMARK.json comes out correct, its result line has the contract's
form, a new configuration, mix, metric and cell are picked up from new
files alone, and planted faults make `correct` false."""
import copy
import json
import math
import os
import shutil

import pytest
import torch

from nerfbench import harness, run, spec
from nerfbench.tests.tiny import tiny_config, tiny_traffic, write_tree

SEED = 2**31 + 12345  # more than 32 signed bits hold
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def run_tiny(name, trace=False, faults=None, base=spec.HERE, bench=BENCH, cfg=None, tr=None):
    cell = spec.workload(bench, name)
    return harness.run_cell(cell, cfg or tiny_config(cell["config"]),
                            tr or tiny_traffic(cell["traffic"]), spec.limits(name, base), SEED,
                            0.5, trace, "cpu", spec.metrics_for(bench, name, "per_layer"),
                            base=base, faults=faults)


def check_line(out, bench, name, trace):
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared" and set(keys) <= {*keys[:5], "breakdown", "compared"}
    assert isinstance(out["correct"], bool) and out["attempted"] > 0 and out["failed"] == 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in spec.metrics_for(bench, name, section)}
    for k, v in out["metrics"].items():
        assert allowed[k] == v["unit"] and math.isfinite(v["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        for part in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][part]) <= 10
    else:
        assert set(out["metrics"]) == set(allowed)
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_correct_against_the_reference(name):
    out = run_tiny(name)
    check_line(out, BENCH, name, trace=False)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("name", ["chair.train", "flagship.render"])
def test_traced_run_line(name):
    out = run_tiny(name, trace=True)
    check_line(out, BENCH, name, trace=True)
    assert out["correct"]


def test_benchmark_entries_have_their_files():
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert spec.traffic(w["traffic"])["kind"] in ("train", "render")
        lim = spec.limits(w["name"])
        assert all(v >= 0 for v in lim.values())
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["reduced"] == spec.config(c["name"])["reduced"]
    for m in BENCH["per_layer"]:
        mod = spec.metric_reader(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (m["name"], m["unit"], m["layer"],
                                                              m["moves"])


def test_new_parts_are_picked_up_from_new_files(tmp_path):
    """A new configuration, mix, metric and cell: files and entries only;
    then a new scene kind that gives a ray pool, and a configuration that
    trains from it: a file and entries only."""
    base = write_tree(str(tmp_path), {}, {}, {})
    cfg = tiny_config("chair")
    cfg["name"] = "chair_l8"
    cfg["settings"]["n_levels"] = 8
    cfg["argv"] = cfg["argv"] + ["--n_levels", "8"]
    tr = tiny_traffic("train_steady")
    tr["setup_steps"] = 12
    write_tree(base, {"chair_l8": cfg}, {"steady_12": tr},
               {"chair_l8.steady": spec.limits("chair.train")})
    with open(os.path.join(base, "metrics", "steps_traced.py"), "w") as f:
        f.write('NAME = "steps_traced"\nUNIT = "steps"\nLAYER = "loop and blocks"\n'
                'MOVES = "train_rays_per_s"\n\n\ndef read(ctx):\n    return float(ctx["traced_units"])\n')
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "chair_l8.steady", "config": "chair_l8",
                               "traffic": "steady_12", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "chair.train" in m.get("workloads", []):
            m["workloads"].append("chair_l8.steady")
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "loop and blocks",
                               "moves": "train_rays_per_s", "workloads": ["chair_l8.steady"]})
    cell = spec.workload(bench, "chair_l8.steady")
    assert spec.config(cell["config"], base)["settings"]["n_levels"] == 8
    assert spec.traffic(cell["traffic"], base)["setup_steps"] == 12
    out = run_tiny("chair_l8.steady", trace=True, base=base, bench=bench,
                   cfg=spec.config("chair_l8", base), tr=spec.traffic("steady_12", base))
    assert out["correct"]
    assert out["metrics"]["steps_traced"]["value"] == 4.0  # one traced span of i_print 4

    shutil.copy(os.path.join(os.path.dirname(__file__), "ring_pool_scene.py"),
                os.path.join(base, "scenes", "panorama.py"))
    cfg = tiny_config("chair")
    cfg["name"] = "chair_pano"
    cfg["argv"] = [a for a in cfg["argv"] if a != "--no_batching"]
    cfg["scene"] = dict(cfg["scene"], kind="panorama")
    write_tree(base, {"chair_pano": cfg}, {}, {"chair_pano.steady": spec.limits("chair.train")})
    bench["workloads"].append({"name": "chair_pano.steady", "config": "chair_pano",
                               "traffic": "steady_12", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "chair.train" in m.get("workloads", []):
            m["workloads"].append("chair_pano.steady")
    out = run_tiny("chair_pano.steady", base=base, bench=bench,
                   cfg=spec.config("chair_pano", base), tr=spec.traffic("steady_12", base))
    check_line(out, bench, "chair_pano.steady", trace=False)
    assert out["correct"], out["compared"]


TRAIN = [c for c in CELLS if spec.traffic(spec.workload(BENCH, c)["traffic"])["kind"] == "train"]
RENDER = [c for c in CELLS if c not in TRAIN]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(name):
    def frozen(trainer):
        trainer.optimizer.step = lambda closure=None: None
    out = run_tiny(name, faults={"program": frozen})
    assert not out["correct"]
    assert out["compared"]["grad.trained"]["value"] > 0.5


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_fails(name, monkeypatch):
    import hashnerf_torch.train.driver as drv

    def half(x, y):
        n = x.shape[0] // 2
        return torch.mean((x[:n] - y[:n]) ** 2)

    out = run_tiny(name, faults={"program": lambda t: monkeypatch.setattr(
        drv, "img2mse", half)})
    assert not out["correct"]
    assert out["compared"]["loss.trained"]["value"] > out["compared"]["loss.trained"]["limit"]


@pytest.mark.parametrize("name", RENDER)
def test_an_altered_answer_fails(name):
    def alter(frames):
        for _, rgb in frames:
            rgb[0, 0, 0] += 0.25
    out = run_tiny(name, faults={"frames": alter})
    assert not out["correct"]
    assert abs(out["compared"]["rgb_max_gap"]["value"] - 0.25) < 1e-3


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "chair.train", "--seed", str(SEED), "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
