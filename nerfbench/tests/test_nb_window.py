"""The window's arithmetic: rates over the whole window, the tail over
every frame, and the trace's busy, idle and labels."""
from nerfbench import trace, traffic


def test_rate_is_all_work_over_all_time():
    assert traffic.rate(1000, 1024, 4.0) == 256000.0
    # a stall adds time and no work
    assert traffic.rate(1000, 1024, 4.5) < traffic.rate(1000, 1024, 4.0)


def test_p90_over_all_frames_moves_with_a_stall():
    times = [0.2] * 100
    assert traffic.percentile(times, 90) == 0.2
    stalled = times[:89] + [1.0] * 11  # 11 stalled frames: past the 90th
    assert traffic.percentile(stalled, 90) == 1.0
    assert traffic.percentile(times[:95] + [1.0] * 5, 90) == 0.2  # within the 10%


def test_end_to_end_of_a_render_window():
    win = {"units": 100, "failed": 0, "seconds": 20.0, "times": [0.2] * 99 + [2.0]}
    e = traffic.end_to_end("render", win, {}, (400, 400))
    assert e["render_rays_per_s"]["value"] == 100 * 160000 / 20.0
    assert e["render_frame_ms_p90"]["value"] == 200.0
    t = traffic.end_to_end("train", {"units": 500, "seconds": 2.0}, {"N_rand": 1024})
    assert t["train_rays_per_s"] == {"value": 256000.0, "unit": "rays/s"}


def test_merge_two_slices():
    a = {"units": 2, "failed": 0, "seconds": 1.0, "frames": [1, 2], "times": [0.5, 0.5]}
    b = {"units": 1, "failed": 1, "seconds": 0.4, "frames": [3], "times": [0.4]}
    m = traffic.merge(a, b)
    assert m == {"units": 3, "failed": 1, "seconds": 1.4, "frames": [1, 2, 3],
                 "times": [0.5, 0.5, 0.4]}


def test_trace_busy_idle_and_labels():
    ms = 1_000_000
    spans = [(0, 100 * ms, trace.WINDOW), (0, 60 * ms, "nb.block_replay"),
             (60 * ms, 100 * ms, "nb.loss_read")]
    dev = [(10 * ms, 30 * ms, "k_a"), (20 * ms, 40 * ms, "k_b"),  # overlap: union 10-40
           (50 * ms, 55 * ms, "k_a"), (90 * ms, 120 * ms, "k_c")]  # clipped at 100
    t = trace.summarize_events(dev, spans)
    assert abs(t["window_s"] - 0.1) < 1e-12
    assert abs(t["busy_s"] - (0.030 + 0.005 + 0.010)) < 1e-12
    assert abs(t["ops"]["k_a"] - 0.025) < 1e-12 and abs(t["ops"]["k_c"] - 0.010) < 1e-12
    # gaps 0-10, 40-50 under block_replay; 55-90 straddles (middle 72.5: loss_read)
    assert abs(t["idle"]["nb.block_replay"] - 0.020) < 1e-12
    assert abs(t["idle"]["nb.loss_read"] - 0.035) < 1e-12
    assert trace.top(t["ops"], 1) == [["k_a", t["ops"]["k_a"]]]
    assert abs(trace.seconds_matching({"void sgemm_x": 1.0, "gemv2T": 2.0, "fill": 4.0},
                                      ("GEMM", "gemv")) - 3.0) < 1e-12
