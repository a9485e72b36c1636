"""The port's measurement tools at tiny widths on the CPU (device="cpu"):
render_bench, profile_step, bench_quality with quality_summary over its
curve, and parity_curve's dataset / ours / merge. Each gives the keys of the
JAX tool's record (RENDER_r05.json, BENCH_QUALITY_r5_c375late.json,
PARITY_CURVE_ours.json) with finite readings, writes only where it is told,
and refuses to run without an output path. CPU readings say nothing of a
device: these tests check the protocol, not the numbers."""
import json
import math
import os

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"N_rand": 32, "N_samples": 8, "N_importance": 8, "log2_hashmap_size": 10,
        "finest_res": 32}


def _record_keys(name):
    with open(os.path.join(ROOT, name)) as f:
        return set(json.load(f))


@pytest.fixture(scope="module")
def blender_set(tmp_path_factory):
    """A 16 x 16 set: 2 train views, 9 test views (testskip 8 keeps 2)."""
    from hashnerf_torch.tools.make_blender_dataset import main

    d = str(tmp_path_factory.mktemp("bl") / "set")
    main([d, "--hw", "16", "--n_train", "2", "--n_val", "1", "--n_test", "9", "--ss", "1"])
    return d


def test_render_bench_protocol(tmp_path, blender_set, monkeypatch):
    import functools

    from hashnerf_torch.tools import render_bench

    # the CLI as a user calls it, its run at tiny widths
    monkeypatch.setattr(render_bench, "run", functools.partial(
        render_bench.run, overrides={**TINY, "occ_update_every": 2}))
    out = tmp_path / "render.json"
    rec = render_bench.main(["--datadir", blender_set, "--json-out", str(out), "--iters", "8",
                             "--frames", "3", "--chunk", "128", "--eval-keeps", "0.5,t0.75:0.5",
                             "--device", "cpu"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    want = _record_keys("RENDER_r05.json") - {"eval_accel_notes", "test_psnr_at_500"}
    want |= {"test_psnr_at_8"}
    # eval_accel_chosen: only when a budget keeps PSNR within 0.05 dB
    assert want - {"eval_accel_chosen", "eval_rays_per_s_accelerated"} <= set(rec)
    assert (rec["H"], rec["W"], rec["rays_per_frame"], rec["n_train_views"]) == (16, 16, 256, 2)
    # JAX's protocol, testskip 8: test frames 0 and 8 of the 9, fewer than --frames
    assert len(rec["frame_s"]) == 2 and len(rec["train_block_rays_per_s"]) == 1
    for k in ("value", "seconds_per_frame", "eval_rays_per_s", "train_rays_per_s_best_block",
              "test_psnr_at_8"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    sweep = rec["eval_keep_sweep"]
    assert [(r["keep_eval"], r["keep_eval_coarse"], r["transmittance"]) for r in sweep] == [
        (0.5, None, False), (0.5, 0.75, True)]
    for r in sweep:
        assert set(r) == {"keep_eval", "keep_eval_coarse", "transmittance", "seconds_per_frame",
                          "eval_rays_per_s", "test_psnr", "psnr_delta_vs_exact_db",
                          "psnr_of_delta_image"}
        assert all(math.isfinite(r[k]) for k in ("test_psnr", "psnr_delta_vs_exact_db",
                                                  "seconds_per_frame"))
    assert sorted(os.listdir(tmp_path)) == ["render.json"]


def test_render_bench_parse_keeps():
    from hashnerf_torch.tools.render_bench import parse_keeps

    assert parse_keeps("0.75, 0.5,t0.5:0.25,,0.375:0.125") == [
        (None, 0.75, False), (None, 0.5, False), (0.5, 0.25, True), (0.375, 0.125, False)]
    assert parse_keeps("") == []


@pytest.mark.parametrize("parity", [False, True], ids=["default", "parity"])
def test_profile_step_readings(parity):
    from hashnerf_torch.tools.profile_step import READINGS, run

    rec = run(parity, "cpu", reps=1, warmup=1, scene_hw=16, overrides=TINY)
    assert set(rec["readings_ms"]) == set(READINGS)
    assert all(math.isfinite(v) and v > 0 for v in rec["readings_ms"].values())
    n = TINY["N_rand"] * (TINY["N_samples"] + TINY["N_importance"])
    if parity:
        assert rec["encode_points"] == n and rec["table"] == [16, 1024, 2]
    else:  # the culled share at keep 0.25, in whole 128-point tiles
        assert rec["encode_points"] == -(-n // 4 // 128) * 128 and rec["table"] == [8, 1024, 4]
    assert rec["device"] == "cpu" and rec["mode"] == ("parity" if parity else "default")


@pytest.mark.parametrize("tool", ["render_bench", "profile_step", "bench_quality",
                                  "quality_summary", "bench_scaling"])
def test_measurement_tools_need_an_output_path(tool, monkeypatch, capsys):
    """Each refuses to start without an output path (none has a default
    one: the repo's root holds the TPU's records)."""
    import importlib
    import sys

    if tool == "bench_quality":
        from hashnerf_torch.bench_quality import main

        with pytest.raises(SystemExit, match="QB_OUT"):
            main(["--device", "cpu"], env={})
        return
    if tool == "bench_scaling":
        import runpy

        monkeypatch.setattr(sys, "argv", ["bench_scaling", "--device", "cpu"])
        with pytest.raises(SystemExit):
            runpy.run_module("hashnerf_torch.tools.bench_scaling", run_name="__main__")
        assert "--json-out" in capsys.readouterr().err
        return
    mod = importlib.import_module(f"hashnerf_torch.tools.{tool}")
    with pytest.raises(SystemExit):
        mod.main(["--device", "cpu"] if tool != "quality_summary" else ["--json-glob", "x"])
    assert "required" in capsys.readouterr().err


def test_bench_quality_curve_and_summary(tmp_path):
    """Two blocks of the tpu-fast mode (culling from step 4, a keep
    schedule) on a tiny scene: the curve, the steady-window rule, the
    result's keys; then quality_summary over it."""
    from hashnerf_torch.bench_quality import iters_to, run
    from hashnerf_torch.tools.quality_summary import main as summary

    env = {"QB_ITERS": "8", "QB_BLOCK": "4", "QB_VIEWS": "4", "QB_NTEST": "1", "QB_CHUNK": "128",
           "QB_KEEP_SCHEDULE": "0:0.5,4:0.25", "QB_UPDATE_EVERY": "2", "QB_TAG": "tiny"}
    res = run(env, "cpu", scene_hw=16, overrides={**TINY, "occ_warmup": 2})
    assert set(res) >= _record_keys("BENCH_QUALITY_r5_c375late.json")
    assert [p["iter"] for p in res["curve"]] == [4, 8]
    assert res["mode"] == "tiny" and res["metric"] == "test_psnr_at_8"
    assert res["knobs"]["keep_schedule"] == "0:0.5,4:0.25"
    assert all(math.isfinite(p["test_psnr"]) for p in res["curve"])
    # on the CPU no block captures a graph; the window is the last third
    # of the blocks (one) under a keep schedule
    assert [f for _, _, f in res["block_times"]] == [False, False]
    assert res["steady_step_ms"] == pytest.approx(res["block_times"][-1][1] / 4 * 1e3)
    assert iters_to(res["curve"], 0.0) == 4 and iters_to(res["curve"], 1e3) is None
    (tmp_path / "q_tiny.json").write_text(json.dumps(res))
    text = summary(["--json-glob", str(tmp_path / "q_*.json"), "--out", str(tmp_path / "s.md")])
    assert "| tiny | cpu | sphere | 32 |" in text


def test_parity_curve_stages(tmp_path):
    """dataset (JAX's protocol set), ours (one milestone, tiny widths) and
    merge against the recorded reference curves, each written where the
    caller says."""
    from hashnerf_torch.tools import parity_curve as pc
    from hashnerf_torch.utils.png import read_png

    data = str(tmp_path / "parity_tiny")
    pc.main(["dataset", data])
    assert sorted(os.listdir(os.path.join(data, "train")))[:1] == ["r_000.png"]
    assert len(os.listdir(os.path.join(data, "train"))) == 24
    assert read_png(os.path.join(data, "test", "r_001.png")).shape == (100, 100, 4)
    ours = tmp_path / "ours.json"
    rec = pc.run_ours(data, str(ours), seed=3, device="cpu", n_iters=pc.MILESTONE,
                      overrides={**TINY, "chunk": 2048})
    assert json.loads(ours.read_text()) == rec
    assert rec["seed"] == 3 and [p["iter"] for p in rec["curve"]] == [pc.MILESTONE]
    assert set(rec) >= _record_keys("PARITY_CURVE_ours.json") - {"backend", "framework"}
    merged = pc.merge(str(tmp_path / "merged.json"),
                      [os.path.join(ROOT, f"PARITY_CURVE_ref{s}.json") for s in ("", "_s1", "_s2")],
                      [str(ours)])
    assert [r["iter"] for r in merged["milestones"]] == [pc.MILESTONE]
    assert merged["milestones"][0]["n_seeds"] == [3, 1]
    assert sorted(os.listdir(tmp_path)) == ["merged.json", "ours.json", "parity_tiny"]
