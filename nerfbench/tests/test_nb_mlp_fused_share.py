"""mlp_fused_share.render's reader on synthetic ctxs."""
import pytest

from nerfbench import spec


def _reader():
    return spec.metric_reader("mlp_fused_share.render")


def _ctx(kind="render", **launches):
    return {"on_card": True, "kind": kind, "launches": launches, "traced_units": 3}


@pytest.mark.parametrize("fused,share", [(3 * 41_943_040, 100.0), (0, 0.0),
                                         (3 * 20_971_520, 50.0)],
                         ids=["bf16_net", "float32_net", "half"])
def test_reads_the_fused_points_over_the_mlp_points(fused, share):
    """100 where the bf16 net answers every point (flagship.render), 0 where
    a float32 net answers them (chair.render)."""
    r = _reader()
    assert (r.NAME, r.UNIT, r.LAYER, r.MOVES) == ("mlp_fused_share.render", "%", "MLPs",
                                                  "render_rays_per_s")
    got = r.read(_ctx(mlp_points=3 * 41_943_040, mlp_fused_points=fused, field_mlp_fwd=30))
    assert got == pytest.approx(share)


@pytest.mark.parametrize("ctx", [
    _ctx(mlp_points=3 * 41_943_040),  # the parent's program: no mlp_fused_points
    _ctx(mlp_fused_points=0),  # no mlp_points
    _ctx(mlp_points=0, mlp_fused_points=0),  # no point reached an MLP
    _ctx(kind="train", mlp_points=262_144, mlp_fused_points=65_536),
    {"on_card": True, "kind": "render", "launches": None, "traced_units": 3},
], ids=["no_fused_counter", "no_points_counter", "no_points", "train", "untraced"])
def test_reads_nothing_without_both_counters_points_or_a_render(ctx):
    assert _reader().read(ctx) is None
