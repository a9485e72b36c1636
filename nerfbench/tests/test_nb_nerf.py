"""The classic NeRF configuration (configs/nerf.json, families/nerf.py):
the family's reference query against the port's query_fn at the published
widths; its counts; a tiny nerf.train run through run_cell that reads
correct, and the planted faults that make it false; the counter that
mlp_gemm_roofline.train checks, and when that reader reads nothing. The
test marked `cuda` runs the controls on the card."""
import copy
import types

import pytest
import torch

from nerfbench import control, counts, harness, spec
from nerfbench.tests.tiny import TINY_SCENE, tiny_traffic, write_tree

SEED = 2**31 + 4242
CFG = spec.config("nerf")
FAM = spec.family_of(CFG)
# The tiny cell: tiny.py's sizes, and the nets cut to W 32 (depth, skip and
# both encodings as published).
TINY = {"N_rand": 32, "N_samples": 8, "N_importance": 8, "precrop_iters": 2, "i_print": 4,
        "steps_per_dispatch": 2, "chunk": 64, "netwidth": 32, "netwidth_fine": 32}
# On the CPU every number reads 0 (the toy family's limits, test_nb_family.py);
# the planted faults read 1e-3 and more in loss.trained and move.trained.
LIMITS = {"loss.start": 1e-6, "grad.start": 1e-5, "move.start": 1e-4,
          "loss.trained": 1e-6, "grad.trained": 1e-5, "move.trained": 1e-4}


def _tiny_config() -> dict:
    cfg = copy.deepcopy(CFG)
    for k, v in TINY.items():
        cfg["settings"][k] = v
        cfg["argv"] = cfg["argv"] + [f"--{k}", str(v)]
    cfg["scene"] = dict(cfg["scene"], **TINY_SCENE)
    return cfg


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = write_tree(str(tmp_path_factory.mktemp("nb")), {"nerf": _tiny_config()},
                      {"train_steady": tiny_traffic("train_steady")}, {"nerf.train": LIMITS})
    return base, spec.load_benchmark()


def run_tiny(tree, trace=False, faults=None):
    base, bench = tree
    w = spec.workload(bench, "nerf.train")
    return harness.run_cell(w, spec.config("nerf", base), spec.traffic(w["traffic"], base),
                            spec.limits("nerf.train", base), SEED, 0.5, trace, "cpu",
                            spec.metrics_for(bench, "nerf.train", "per_layer"), base=base,
                            faults=faults)


def test_the_family_counts_the_published_nets():
    s = CFG["settings"]
    # 63*256 + 4*256*256 + 319*256 + 2*256*256 + 256*256 + 256 + 283*128 + 128*3
    assert FAM.macs_per_point(s) == FAM.macs_per_point(s, True) == 593408
    assert counts.train_points_per_step(s) == 1024 * (64 + 192)
    assert FAM.train_flops_per_step(s) == 6 * 593408 * 262144
    assert abs(FAM.train_flops_per_step(s) - 9.333e11) < 0.001e11
    # the GEMMs skip the input gradient of each net's 63 -> 256 first layer
    assert FAM.train_gemm_flops_per_step(s) == (6 * 593408 - 2 * 63 * 256) * 262144
    assert FAM.render_flops_per_frame(s, 400, 400) == 2 * 593408 * 160000 * 256
    shapes = FAM.layer_shapes(s)
    assert shapes["pts.0"] == (256, 63) and shapes["pts.5"] == (256, 319)
    assert shapes["views.0"] == (128, 283) and sum(o * i + o for o, i in shapes.values()) == 595844
    assert FAM.grid(s) is None and CFG["family"] == "nerf" and CFG["reduced"] == []


def test_the_reference_query_is_the_ports_at_the_published_widths():
    """Both nets at D 8, W 256 on the family's weights, 384 points: the
    same float32 products in the same order, so equal up to float32
    rounding."""
    from hashnerf_torch.models.factory import NGPState, query_fn
    from hashnerf_torch.train.driver import model_config_from_args

    s = CFG["settings"]
    state = NGPState(model_config_from_args(harness.program_args(CFG, "cpu")))
    init = FAM.initial_weights(s, SEED, "cpu")
    leaves = FAM.program_leaves(types.SimpleNamespace(state=state))
    assert set(leaves) == set(init) and len(init) == 2 * 2 * 12
    with torch.no_grad():
        for name, p in leaves.items():
            p.copy_(init[name])
    gen = torch.Generator().manual_seed(7)
    pts = torch.rand((4, 96, 3), generator=gen) * 4.0 - 2.0
    d = torch.randn((4, 3), generator=gen)
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    bbox = torch.tensor([[-1.6] * 3, [1.6] * 3])
    ref = FAM.Reference(s, {}, "cpu")
    for fine in (False, True):
        with torch.no_grad():
            got = query_fn(state, pts, viewdirs, bbox, fine=fine)
            want = ref.query(init, pts, viewdirs, fine)
        assert got.shape == want.shape == (4, 96, 4)
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-7)


def test_a_tiny_nerf_train_run_is_correct(tree):
    out = run_tiny(tree)
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == set(LIMITS)


def test_a_traced_tiny_run_counts_the_mlp_points(tree):
    """The traced slice's counter is the configuration's points a step
    times its steps; off the card the roofline reads nothing."""
    seen = {}
    read = spec.read_metrics

    def keep_ctx(entries, ctx, base=spec.HERE):
        seen.update(ctx)
        return read(entries, ctx, base)

    spec.read_metrics = keep_ctx
    try:
        out = run_tiny(tree, trace=True)
    finally:
        spec.read_metrics = read
    assert out["correct"], out["compared"]
    c = seen["launches"]
    steps = c["steps_eager"] + c["steps_replayed"]
    assert steps == 4 and c["mlp_points"] == counts.train_points_per_step(seen["settings"]) * steps
    assert "mlp_gemm_roofline.train" not in out["metrics"] and seen["encode"] is None


def test_a_state_left_unchanged_is_refused(tree):
    def frozen(trainer):
        trainer.optimizer.step = lambda closure=None: None
    out = run_tiny(tree, faults={"program": frozen})
    assert not out["correct"]
    assert out["compared"]["move.trained"]["value"] > 0.5


def test_half_the_batch_is_refused(tree, monkeypatch):
    import hashnerf_torch.train.driver as drv

    def half(x, y):
        n = x.shape[0] // 2
        return torch.mean((x[:n] - y[:n]) ** 2)

    out = run_tiny(tree, faults={"program": lambda t: monkeypatch.setattr(drv, "img2mse", half)})
    assert not out["correct"]
    assert out["compared"]["loss.trained"]["value"] > out["compared"]["loss.trained"]["limit"]


@pytest.mark.cuda
def test_the_controls_fail_on_the_card():
    """On the card at the tiny cell's sizes: the reference with TF32
    products, and with half the batch, against the float32 reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rec = control.read_seed(_tiny_config(), tiny_traffic("train_steady"), SEED, "cuda",
                            check_frames=1, chunk=64)
    assert max(rec["control"].values()) > 10 * max(max(rec["program"].values()), 1e-7), rec
    assert rec["half_batch"]["loss.trained"] > 1e-2


GEMMS = {"sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8": 0.030,
         "void cutlass::Kernel<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>": 0.010,
         "void at::native::vectorized_elementwise_kernel<4, relu>": 0.020}


def _ctx(**launches):
    return {"on_card": True, "kind": "train", "trace": {"ops": dict(GEMMS)},
            "launches": launches, "settings": CFG["settings"], "family": FAM}


def test_the_roofline_reads_the_gemms_share_of_the_float32_peak():
    reader = spec.metric_reader("mlp_gemm_roofline.train")
    pts = counts.train_points_per_step(CFG["settings"])
    got = reader.read(_ctx(steps_eager=0, steps_replayed=3, mlp_points=3 * pts))
    assert got == pytest.approx(100.0 * 3 * (6 * 593408 - 2 * 16128) * pts / 0.040 / 67e12,
                                rel=1e-9)


@pytest.mark.parametrize("launches", [
    {"steps_eager": 0, "steps_replayed": 3},  # no counter (the parent)
    {"steps_eager": 0, "steps_replayed": 3, "mlp_points": 3 * 262144 - 1},  # a point short
    {"steps_eager": 1, "steps_replayed": 3, "mlp_points": 3 * 262144},  # a step short
    {"steps_eager": 0, "steps_replayed": 0, "mlp_points": 0},
], ids=["no_counter", "fewer_points", "fewer_steps", "no_steps"])
def test_the_roofline_reads_nothing_without_the_whole_count(launches):
    assert spec.metric_reader("mlp_gemm_roofline.train").read(_ctx(**launches)) is None


def test_the_roofline_reads_nothing_for_a_family_without_a_gemm_count():
    pts = counts.train_points_per_step(CFG["settings"])
    ctx = _ctx(steps_eager=0, steps_replayed=3, mlp_points=3 * pts)
    ctx["family"] = types.SimpleNamespace(train_flops_per_step=FAM.train_flops_per_step)
    assert spec.metric_reader("mlp_gemm_roofline.train").read(ctx) is None
