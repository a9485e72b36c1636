"""The port's spans and counters (utils/profiling.py): a span is a null
context unless a torch.profiler records, and then a named range of its
timeline; the counters ride with the kernel launch counts, through a CUDA
graph's tally too; a CPU trainer's steps and frames open the spans and
raise the counters their work calls for."""
import pytest
import torch

from hashnerf_torch import kernels
from hashnerf_torch.utils import profiling

torch.set_num_threads(2)

SMALL = dict(N_rand=32, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
             use_viewdirs=True, finest_res=32, log2_hashmap_size=10, white_bkgd=True,
             no_batching=True, perturb=1.0)
# the classic NeRF: positional encodings, D 8 with the skip, coarse and fine
SMALL_NERF = dict(N_rand=32, N_samples=8, N_importance=8, lrate=5e-4, lrate_decay=250,
                  use_viewdirs=True, i_embed=0, i_embed_views=0, multires=4, multires_views=2,
                  netdepth=8, netwidth=16, netdepth_fine=8, netwidth_fine=16, white_bkgd=True,
                  no_batching=True, perturb=1.0)
# culled, an update every 4 steps from the start, culling from step 4
SMALL_CULLED = dict(SMALL, n_levels=4, n_features_per_level=2, log2_hashmap_size=13,
                    log2_blocks=10, packed_layout=True, share_fine=True, aabb_clip=True,
                    use_occupancy=True, occ_resolution=32, occ_warmup=4, occ_update_every=4,
                    occ_keep_fraction=0.25, occ_keep_coarse=0.5, occ_block=8)


def _trainer(settings, hw=24):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    args = config_parser().parse_args([])
    for k, v in settings.items():
        setattr(args, k, v)
    return Trainer(args, make_synthetic_scene(H=hw, W=hw, n_train=3, n_test=1), device="cpu")


def _traced(fn):
    """fn() under a CPU profiler: (its result, the hn.* spans as (start,
    end, name, thread) in start order)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((ev.start_ns(), ev.end_ns(), ev.name(), ev.start_thread_id())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.is_user_annotation() and ev.name().startswith("hn."))
    return out, spans


def _names(spans):
    out = {}
    for _, _, n, _ in spans:
        out[n] = out.get(n, 0) + 1
    return out


def _inside(spans, child, parent):
    """Every `child` span lies inside a `parent` span of its thread."""
    outer = [(a, b, t) for a, b, n, t in spans if n == parent]
    return all(any(a0 <= a and b <= b0 and t == t0 for a0, b0, t0 in outer)
               for a, b, n, t in spans if n == child)


def test_annotate_without_a_profiler_is_the_shared_null_context(monkeypatch):
    """With no profiler recording, a span makes no record_function: every
    annotate returns one null context."""
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.annotate("hn.a"), profiling.annotate("hn.b")
    assert a is b
    with a:
        with b:
            pass


def test_annotate_records_named_nested_spans():
    def work():
        with profiling.annotate("hn.outer"):
            for _ in range(2):
                with profiling.annotate("hn.inner"):
                    torch.ones(8) * 2

    _, spans = _traced(work)
    assert _names(spans) == {"hn.outer": 1, "hn.inner": 2}
    assert _inside(spans, "hn.inner", "hn.outer")
    _, none = _traced(lambda: None)
    assert none == []


def test_counters_read_reset_and_ride_with_launch_counts():
    kernels.reset_launch_counts()
    assert set(profiling.counters()) == set(profiling.COUNTERS)
    profiling.count("steps_eager")
    profiling.count("grid_updates", 3)
    counts = kernels.launch_counts()
    assert counts["steps_eager"] == 1 and counts["grid_updates"] == 3
    assert set(counts) == kernels.COUNTED == set(kernels.KERNELS) | set(profiling.COUNTERS)
    # the registry of launch.Kernel: each C entry, counted under its own name
    assert set(kernels.KERNELS) == {
        "segment_accumulate_k1", "hash_encode_fwd", "hash_encode_bwd_expand",
        "segment_accumulate_k4", "segment_accumulate_k5", "hash_encode_bwd",
        "packed_encode_fwd", "packed_encode_bwd", "field_colour_input_fwd",
        "field_colour_input_bwd", "field_raw_fwd", "field_raw_bwd", "field_mlp_fwd",
            "field_mlp_fwd_f32"}
    assert all(k.entry == name for name, k in kernels.KERNELS.items())
    kernels.add_launches({"hash_encode_fwd": 2, "grid_updates": 1}, 3)
    counts = kernels.launch_counts()
    assert counts["hash_encode_fwd"] == 6 and counts["grid_updates"] == 6
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())
    with pytest.raises(KeyError):
        profiling.count("no_such_counter")


def test_graph_tally_adds_program_counters_on_replay():
    """train/graphs.py adds what a capture counted on every replay: the
    program's counters with the launches and the collectives."""
    from hashnerf_torch.parallel import mesh
    from hashnerf_torch.train import graphs

    kernels.reset_launch_counts()
    mesh.reset_collective_counts()
    captured = {"steps_replayed": 1, "grid_updates": 1, "hash_encode_fwd": 2, "all_reduce": 1}
    for _ in range(16):
        graphs._add(captured)
    counts = graphs._counts()
    assert counts["steps_replayed"] == 16 and counts["grid_updates"] == 16
    assert counts["hash_encode_fwd"] == 32 and counts["all_reduce"] == 16
    graphs._add(captured, -16)  # a capture takes its own counts off again
    assert not any(graphs._counts().values())


def test_run_steps_counts_and_spans_eager_steps_and_grid_updates():
    """Two steps short of the warmup run eagerly; a run of 10 from there
    runs 2 eager steps (the second updates the grid) and two blocks of 4
    with an update each. Every eager step is an hn.step, every update an
    hn.grid_update, every readiness read an hn.host_read."""
    t = _trainer(SMALL_CULLED)
    kernels.reset_launch_counts()
    t.run_steps(2, block_size=4)
    # each step queries the coarse and the fine pass, each with its rays' directions
    assert profiling.counters() == {"steps_eager": 2, "steps_replayed": 0, "grid_updates": 0,
                                    "graph_captures": 0, "host_reads": 1, "views_per_ray": 4,
                                    "mlp_points": 2 * 32 * (8 + 16), "mlp_fused_points": 0}
    kernels.reset_launch_counts()
    _, spans = _traced(lambda: t.run_steps(10, block_size=4))
    c = profiling.counters()
    names = _names(spans)
    assert c["steps_eager"] == 2 and c["steps_replayed"] == 8 and c["grid_updates"] == 3
    assert c["graph_captures"] == 0 and c["host_reads"] >= 2
    # two passes a step, and each grid update's query (direction +z)
    assert c["views_per_ray"] == 2 * 10 + c["grid_updates"]
    assert names["hn.run_steps"] == 1 and names["hn.block"] == 2
    assert names["hn.step"] == c["steps_eager"]
    assert names["hn.grid_update"] == c["grid_updates"]
    assert names["hn.host_read"] == c["host_reads"]
    assert names["hn.forward"] == names["hn.backward"] == names["hn.sample"] == 10
    assert names["hn.optimizer"] == 20  # zero_grad and RAdam's step
    for child in ("hn.forward", "hn.backward", "hn.optimizer", "hn.grid_update"):
        assert all(any(a0 <= a and b <= b0 for a0, b0, n0, _ in spans
                       if n0 in ("hn.step", "hn.block"))
                   for a, b, n, _ in spans if n == child), child
    for child in ("hn.step", "hn.block", "hn.sample", "hn.host_read"):
        assert _inside(spans, child, "hn.run_steps"), child
    assert t.global_step == 12


def test_spans_change_no_step():
    """A trainer's steps under a profiler are the same bits as without."""
    a, b = _trainer(SMALL_CULLED), _trainer(SMALL_CULLED)
    ma = a.run_steps(6, block_size=4)
    mb, spans = _traced(lambda: b.run_steps(6, block_size=4))
    assert spans
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(a.training_state(), b.training_state()):
        assert torch.equal(x, y)


def test_query_spans_hold_the_encode_mlp_and_encode_backward():
    """A per-corner table's eager step: each query holds one hn.encode
    and one hn.mlp; K6's wrapper (its plain version here) runs in
    hn.encode.bwd, inside the step's backward."""
    t = _trainer(SMALL)
    _, spans = _traced(lambda: t.step(t.sample_batch(False)))
    names = _names(spans)
    assert names["hn.query"] == names["hn.encode"] == names["hn.mlp"] == 2
    assert names["hn.encode.bwd"] == 2  # the coarse and the fine pass
    assert _inside(spans, "hn.encode", "hn.query") and _inside(spans, "hn.mlp", "hn.query")
    assert _inside(spans, "hn.encode.bwd", "hn.backward")
    assert _inside(spans, "hn.query", "hn.forward")


@pytest.mark.parametrize("culled", [False, True])
def test_render_image_spans_a_chunk_each(culled):
    """A 24 x 24 frame in chunks of 128 rays: 5 chunks (the last padded),
    each with its passes, sample_pdf and composites; culled at eval, each
    pass's cut in hn.cull."""
    t = _trainer(SMALL_CULLED)
    if culled:
        t._occ_ready = True
        t.eval_cull = True
        t.occ_grid.fill_(1.0)
    _, spans = _traced(lambda: t.render_image(t.scene.render_poses[0], chunk=128))
    names = _names(spans)
    assert names["hn.render"] == names["hn.render.gather"] == 1
    assert names["hn.render.chunk"] == 5
    for n in ("hn.march.coarse", "hn.march.fine", "hn.sample_pdf"):
        assert names[n] == 5, n
    assert names["hn.composite"] == names["hn.query"] == 10
    assert _inside(spans, "hn.render.chunk", "hn.render")
    assert _inside(spans, "hn.march.fine", "hn.render.chunk")
    if culled:
        # a chunk: the coarse scores, the coarse cut and its undoing, the
        # fine samples' scores and sort, the fine cut and its undoing
        assert names["hn.cull"] == 5 * 6
    else:
        assert "hn.cull" not in names


@pytest.mark.parametrize("settings", [SMALL, SMALL_NERF], ids=["ngp", "nerf"])
def test_mlp_points_counts_each_querys_points(settings):
    """R x S points a query: a step's coarse pass 32 x 8, its fine pass
    32 x 16; eager, and through a run_steps block, which counts its steps
    as a graph's capture would."""
    from hashnerf_torch.models.factory import query_fn

    t = _trainer(settings)
    kernels.reset_launch_counts()
    with torch.no_grad():
        query_fn(t.state, torch.zeros((5, 7, 3)), torch.ones((5, 3)) / 3 ** 0.5, t.bbox)
    assert profiling.counters()["mlp_points"] == 35
    kernels.reset_launch_counts()
    t.step(t.sample_batch(False))
    assert profiling.counters()["mlp_points"] == 32 * (8 + 16)
    kernels.reset_launch_counts()
    t.run_steps(4, block_size=2)
    c = profiling.counters()
    assert c["steps_replayed"] == 4 and c["steps_eager"] == 0
    assert c["mlp_points"] == 4 * 32 * (8 + 16)


def test_nerf_mlp_spans_the_trunk_and_the_view_branch():
    """A NeRF step's queries: each hn.mlp holds one hn.mlp.trunk (the D
    layers and the skip) and one hn.mlp.views; a NeRF has no encode
    backward."""
    t = _trainer(SMALL_NERF)
    _, spans = _traced(lambda: t.step(t.sample_batch(False)))
    names = _names(spans)
    assert names["hn.mlp"] == names["hn.mlp.trunk"] == names["hn.mlp.views"] == 2
    assert _inside(spans, "hn.mlp.trunk", "hn.mlp") and _inside(spans, "hn.mlp.views", "hn.mlp")
    assert "hn.encode.bwd" not in names
    trunk = sorted((a, b) for a, b, n, _ in spans if n == "hn.mlp.trunk")
    views = sorted((a, b) for a, b, n, _ in spans if n == "hn.mlp.views")
    assert all(tb <= va for (_, tb), (va, _) in zip(trunk, views))


def test_nerf_small_spans_are_unchanged():
    """NeRFSmall's eager step opens the spans it opened before the classic
    NeRF's trunk and view-branch spans: none of theirs."""
    t = _trainer(SMALL)
    _, spans = _traced(lambda: t.step(t.sample_batch(False)))
    assert _names(spans) == {
        "hn.step": 1, "hn.sample": 1, "hn.forward": 1, "hn.backward": 1, "hn.optimizer": 2,
        "hn.march.coarse": 1, "hn.march.fine": 1, "hn.sample_pdf": 1, "hn.composite": 2,
        "hn.query": 2, "hn.encode": 2, "hn.mlp": 2, "hn.encode.bwd": 2}
