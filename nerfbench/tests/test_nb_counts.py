"""The yardstick's FLOP and byte counts against hand-worked figures, and
the "ngp" family's counts against the figures the benchmark read before
the model families (families/) took them over."""
import pytest
import torch

from nerfbench import counts, reference as ref, spec

NGP = spec.family_of({})
BBOX = torch.tensor([[-1.6] * 3, [1.6] * 3])
# The counts before the families, for the chair and the flagship at their
# own sizes: (train FLOPs a step, render FLOPs a 400 x 400 frame, the
# encode's forward and backward bytes of the 300 points of _points()).
BEFORE = {"chair": (14696841216.0, 765460480000.0, 340468, 340168),
          "flagship": (2780823552.0, 765460480000.0, 331292, 330992)}


def _points():
    gen = torch.Generator().manual_seed(0)
    return torch.rand((300, 3), generator=gen) * 3.6 - 1.8  # some outside the box


def test_macs_per_point_is_9344():
    s = spec.config("chair")["settings"]
    # 32*64 + 64*16 + 31*64 + 64*64 + 64*3
    assert NGP.macs_per_point(s) == 2048 + 1024 + 1984 + 4096 + 192 == 9344
    assert NGP.sigma_macs_per_point(s) == 3072


def test_chair_step_points_and_flops():
    s = spec.config("chair")["settings"]
    assert counts.train_points_per_step(s) == 1024 * (64 + 192) == 262144
    assert counts.update_points_per_step(s) == 0
    assert abs(NGP.train_flops_per_step(s) - 14.70e9) < 0.005e9
    assert counts.peak_flops(s) == 67e12


def test_flagship_step_points_and_flops():
    s = spec.config("flagship")["settings"]
    # coarse keep 0.375 of 65,536, fine keep 0.125 of 196,608: 24,576 each
    assert counts.train_points_per_step(s) == 24576 + 24576
    assert counts.update_points_per_step(s) == 65536 / 16
    want = 6 * 9344 * 49152 + 2 * 3072 * 4096
    assert NGP.train_flops_per_step(s) == want
    assert abs(want - 2.78e9) < 0.01e9
    assert counts.peak_flops(s) == 989e12


def test_render_frame_flops():
    s = spec.config("chair")["settings"]
    assert NGP.render_flops_per_frame(s, 400, 400) == 2 * 9344 * 160000 * 256


@pytest.mark.parametrize("name", ["chair", "flagship"])
def test_the_ngp_family_counts_as_before(name):
    cfg = spec.config(name)
    fam = spec.family_of(cfg)
    assert fam.__file__ == NGP.__file__ and "family" not in cfg
    s = cfg["settings"]
    train, render, fwd, bwd = BEFORE[name]
    assert fam.macs_per_point(s) == 9344
    assert fam.train_flops_per_step(s) == train
    assert fam.render_flops_per_frame(s, 400, 400) == render
    g = fam.grid(s)
    assert g.table_shapes() == ref.Grid(s).table_shapes() and g.res == ref.Grid(s).res
    assert counts.encode_call_bytes(g, _points(), BBOX, backward=True) == {"forward": fwd,
                                                                            "backward": bwd}


def test_grids_of_the_configurations():
    g = ref.Grid(spec.config("chair")["settings"])
    assert g.res[0] == 16 and g.res[-1] == 512 and len(g.res) == 16
    assert g.table_shapes() == {"table": (16, 1 << 19, 2)}
    f = ref.Grid(spec.config("flagship")["settings"])
    assert f.dense_res == (16, 50) and f.fine_res == (161, 511)
    assert f.table_shapes() == {"dense": (17 ** 3 + 51 ** 3, 8), "fine_table": (2 << 16, 216)}


def _brute_rows(g, pts, bbox):
    """Distinct table entries by a set over every corner, point by point."""
    bmin, bmax = bbox[0], bbox[1]
    xc = torch.minimum(torch.maximum(pts, bmin), bmax)
    seen = set()
    if not g.packed:
        for l, res in enumerate(g.res):
            rows, _ = ref.hash_corners(xc, bmin, bmax, res, g.log2T)
            seen |= {(l, int(r)) for r in rows.reshape(-1)}
    else:
        for li, res in enumerate(g.dense_res):
            b, _ = ref.packed_voxel(xc, bmin, bmax, res)
            seen |= {("d", int(r)) for r in ref.dense_rows(b, res, g.dense_offsets[li]).reshape(-1)}
        for li, res in enumerate(g.fine_res):
            b, _ = ref.packed_voxel(xc, bmin, bmax, res)
            row, slots = ref.fine_rows_slots(b, g, li)
            seen |= {(int(r), int(c)) for r, sl in zip(row, slots) for c in sl}
    return len(seen) * g.F * 4


def test_touched_rows_match_a_brute_count():
    pts = _points()
    for name in ("chair", "flagship"):
        g = ref.Grid(spec.config(name)["settings"])
        assert counts.touched_row_bytes(g, pts, BBOX) == _brute_rows(g, pts, BBOX)


def test_encode_call_bytes():
    g = ref.Grid(spec.config("chair")["settings"])
    pts = torch.zeros((10, 3))  # one voxel corner set a level
    b = counts.encode_call_bytes(g, pts, torch.tensor([[-1.6] * 3, [1.6] * 3]), backward=True)
    rows = counts.touched_row_bytes(g, pts, torch.tensor([[-1.6] * 3, [1.6] * 3]))
    assert rows == 16 * 8 * 2 * 4
    assert b["forward"] == 10 * 12 + 10 * 32 * 4 + 10 + rows
    assert b["backward"] == 10 * 12 + 10 * 32 * 4 + rows
