"""spans.py's reduction on synthetic events: device time by the program
span that launched it, across the caller's and autograd's threads; idle
gaps by the innermost nb.* or hn.* span; trace.py's numbers unchanged by
program spans; span_metrics and the eager-step share's reader."""
import pytest
import torch

from nerfbench import spans as spansm, spec, trace

MAIN, AUTOGRAD = 1, 2
SPANS = [
    (0, 1000, "nb.window", MAIN),
    (10, 900, "nb.block_replay", MAIN),
    (20, 890, "hn.run_steps", MAIN),
    (30, 400, "hn.step", MAIN),
    (200, 350, "hn.backward", MAIN),
    (250, 300, "hn.encode.bwd", AUTOGRAD),
    (450, 880, "hn.block", MAIN),
    (460, 470, "hn.replay.step", MAIN),
    (920, 960, "nb.loss_read", MAIN),
]
# correlation id -> (launch time, launching thread)
LAUNCHES = {1: (40, MAIN), 2: (210, AUTOGRAD), 3: (260, AUTOGRAD), 4: (465, MAIN),
            5: (5, MAIN), 7: (895, MAIN)}
DEV = [
    (50, 100, "k_forward", 1),       # launched in hn.step
    (220, 240, "k_backward", 2),     # autograd's thread, the caller in hn.backward
    (300, 330, "k_encode_bwd", 3),   # autograd's thread, in hn.encode.bwd
    (470, 600, "k_replay", 4),       # a graph launched in hn.replay.step
    (600, 700, "k_replay", 4),
    (-50, 8, "k_before", 5),         # launched outside any program span, clipped
    (960, 1100, "k_no_launch", 6),   # no runtime call found; clipped
    (900, 905, "k_late", 7),         # after hn.run_steps, inside nb.block_replay
]


def _summary():
    return spansm.summarize_events(DEV, SPANS, LAUNCHES)


def test_device_time_by_launching_span():
    s = _summary()
    want = {"hn.step": 50e-9, "hn.backward": 20e-9, "hn.encode.bwd": 30e-9,
            "hn.replay.step": 230e-9, spansm.NO_SPAN: (8 + 40 + 5) * 1e-9}
    assert s["device_by_span"] == pytest.approx(want, abs=1e-15)
    assert s["unlaunched_s"] == pytest.approx(40e-9)
    assert sum(s["device_by_span"].values()) == pytest.approx(sum(s["ops"].values()), rel=1e-12)


def test_idle_gaps_by_the_innermost_span():
    """Gaps (middle: label): 8-50 (29: hn.run_steps, before hn.step
    opens), 100-220 (160: hn.step), 240-300 (270: hn.encode.bwd on
    autograd's thread, the shortest open span), 330-470 (400: hn.step's
    last instant), 700-900 (800: hn.block), 905-960 (932: nb.loss_read)."""
    s = _summary()
    want = {"hn.run_steps": 42e-9, "hn.step": (120 + 140) * 1e-9, "hn.encode.bwd": 60e-9,
            "hn.block": 200e-9, "nb.loss_read": 55e-9}
    assert s["idle"] == pytest.approx(want, abs=1e-15)
    assert sum(s["idle"].values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_trace_numbers_are_the_same_with_and_without_program_spans():
    s = _summary()
    nb_only = [x[:3] for x in SPANS if x[2].startswith("nb.")]
    base = trace.summarize_events([d[:3] for d in DEV], nb_only)
    assert (s["busy_s"], s["window_s"], s["ops"]) == (base["busy_s"], base["window_s"], base["ops"])
    with_hn = trace.summarize_events([d[:3] for d in DEV], [x[:3] for x in SPANS])
    assert (with_hn["busy_s"], with_hn["window_s"], with_hn["ops"]) == (
        base["busy_s"], base["window_s"], base["ops"])
    # and a trace with no program span at all puts all its device time to "no span"
    bare = spansm.summarize_events(DEV, [x for x in SPANS if x[2].startswith("nb.")], LAUNCHES)
    assert (bare["busy_s"], bare["window_s"], bare["ops"]) == (s["busy_s"], s["window_s"], s["ops"])
    assert set(bare["device_by_span"]) == {spansm.NO_SPAN} and bare["spans"] == {}
    assert bare["idle"] == base["idle"]


def test_host_seconds_by_span():
    s = _summary()
    assert s["spans"]["hn.step"] == [1, pytest.approx(370e-9)]
    assert s["spans"]["hn.replay.step"][0] == 1 and "nb.block_replay" not in s["spans"]


def test_trace_events_keep_program_spans_out():
    """trace.py's reader of a real (CPU) profile keeps nb.* ranges alone;
    spans.py's keeps both."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from hashnerf_torch.utils.profiling import annotate

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with annotate("hn.step"):
                torch.ones(4) * 2
    _, nb = trace._events(prof)
    assert [n for _, _, n in nb] == [trace.WINDOW]
    _, both, _ = spansm.events(prof)
    assert sorted(n for _, _, n, _ in both) == ["hn.step", trace.WINDOW]


def test_span_metrics():
    s = {"device_by_span": {"hn.optimizer": 0.004, "hn.grid_update": 0.001,
                            "hn.replay.update": 0.005, "hn.replay.step": 1.0,
                            "hn.render": 0.01, "hn.render.chunk": 0.02, "hn.query": 0.03,
                            "hn.encode": 0.5, "hn.mlp": 0.5},
         "spans": {"hn.step": [4, 0.08]}}
    c = {"steps_eager": 4, "steps_replayed": 96, "grid_updates": 6}
    got = spansm.span_metrics(s, c, 100, "train")
    assert got == pytest.approx({"eager_step_share.train": 4.0, "eager_step_host_ms.train": 20.0,
                                 "optimizer_ms_per_step.train": 1.0, "grid_update_ms.train": 1.0})
    assert spansm.span_metrics(s, c, 2, "render") == pytest.approx(
        {"renderer_ms_per_frame.render": 30.0})
    assert spansm.span_metrics({"device_by_span": {}, "spans": {}}, {}, 3, "train") == {}
    assert spansm.span_metrics({"device_by_span": {}, "spans": {}}, {}, 3, "render") == {}


def test_eager_step_share_reader():
    r = spec.metric_reader("eager_step_share.train")
    assert (r.NAME, r.UNIT, r.LAYER, r.MOVES) == ("eager_step_share.train", "%", "loop and blocks",
                                                   "train_rays_per_s")
    launches = {"hash_encode_fwd": 10, "steps_eager": 12, "steps_replayed": 288}
    assert r.read({"kind": "train", "launches": launches}) == pytest.approx(4.0)
    # the parent's counts have no program counters; a render reads nothing
    assert r.read({"kind": "train", "launches": {"hash_encode_fwd": 10}}) is None
    assert r.read({"kind": "render", "launches": launches}) is None
    assert r.read({"kind": "train", "launches": None}) is None


@pytest.mark.parametrize("cell", ["flagship.train", "chair.render"])
def test_run_on_the_cpu(cell):
    """spans.run at tiny sizes on the CPU: the traced slice's counters and
    program spans; no device events, so no device time to put down."""
    from nerfbench.tests.tiny import tiny_config, tiny_traffic

    w = spec.workload(spec.load_benchmark(), cell)
    tr = tiny_traffic(w["traffic"])
    out = spansm.run(tiny_config(w["config"]), tr, 2**31 + 7, "cpu")
    s = out["summary"]
    assert out["device"] == "cpu" and s["busy_s"] == 0 and s["device_by_span"] == {}
    if tr["kind"] == "train":
        c = out["counters"]
        assert c.get("steps_eager", 0) + c.get("steps_replayed", 0) == out["units"]
        assert s["spans"]["hn.run_steps"][0] == tr["trace_units"]
        assert out["metrics"]["eager_step_share.train"] == pytest.approx(
            100.0 * c.get("steps_eager", 0) / out["units"])
    else:
        assert s["spans"]["hn.render"][0] == out["units"] == tr["trace_units"]
        assert "renderer_ms_per_frame.render" not in out["metrics"]
    assert "graph_captures" not in out["counters"]


def test_device_time_by_span_and_op():
    s = _summary()
    assert s["device_by_span_op"]["hn.replay.step"] == {"k_replay": pytest.approx(230e-9)}
    assert s["device_by_span_op"][spansm.NO_SPAN] == pytest.approx(
        {"k_before": 8e-9, "k_no_launch": 40e-9, "k_late": 5e-9})
    for name, ops in s["device_by_span_op"].items():
        assert sum(ops.values()) == pytest.approx(s["device_by_span"][name])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chair.train", "flagship.train", "chair.render"])
def test_run_puts_every_device_interval_down_on_the_card(cell):
    """At tiny sizes on the card: every device interval finds its runtime
    call, every kernel a program span; the chair's graphed steps land in hn.replay.step; the flagship's
    eager backward launches from autograd's thread, K8 in hn.encode.bwd
    there and the rest in the caller's hn.backward; a frame's work in its
    chunk's spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nerfbench.tests.tiny import tiny_config, tiny_traffic

    w = spec.workload(spec.load_benchmark(), cell)
    out = spansm.run(tiny_config(w["config"]), tiny_traffic(w["traffic"]), 2**31 + 7, "cuda")
    s = out["summary"]
    by = s["device_by_span"]
    assert s["unlaunched_s"] == 0 and sum(by.values()) == pytest.approx(sum(s["ops"].values()))
    # outside the program's spans: the benchmark's host copies alone
    assert all(op.startswith("Memcpy") for op in s["device_by_span_op"].get(spansm.NO_SPAN, {}))
    want = {"chair.train": {"hn.replay.step"},
            "flagship.train": {"hn.encode.bwd", "hn.backward", "hn.optimizer", "hn.encode"},
            "chair.render": {"hn.encode", "hn.mlp", "hn.query", "hn.composite"}}[cell]
    assert want <= set(by), by
    assert len(out["threads"]["spans"]) == (2 if cell == "flagship.train" else 1)
