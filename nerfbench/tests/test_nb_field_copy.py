"""field_copy_ms_per_frame.render's reader on a synthetic ctx."""
import pytest

from nerfbench import spec

OPS = {
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_alig": 0.12,
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_vect": 0.03,
    "void__anonymous_namespace_::field_colour_input_fwd_kernel_float_c": 0.006,
    "void__anonymous_namespace_::field_raw_fwd_kernel_float_const__res": 0.0015,
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_war": 0.09,
    "void__anonymous_namespace_::hash_encode_fwd_kernel_2__float_cons": 0.05,
}


def _reader():
    return spec.metric_reader("field_copy_ms_per_frame.render")


def test_counts_the_copies_and_their_replacements_a_frame():
    r = _reader()
    assert (r.NAME, r.UNIT, r.LAYER, r.MOVES) == ("field_copy_ms_per_frame.render", "ms",
                                                  "field query", "render_rays_per_s")
    ctx = {"on_card": True, "kind": "render", "trace": {"ops": OPS}, "traced_units": 3}
    assert r.read(ctx) == pytest.approx(1e3 * (0.12 + 0.03 + 0.006 + 0.0015) / 3)
    # the parent's program: concatenations alone
    cats = {k: v for k, v in OPS.items() if "field" not in k}
    assert r.read({**ctx, "trace": {"ops": cats}}) == pytest.approx(1e3 * 0.15 / 3)


def test_reads_nothing_off_the_card_in_a_train_cell_or_without_copies():
    r = _reader()
    ctx = {"on_card": True, "kind": "render", "trace": {"ops": OPS}, "traced_units": 3}
    assert r.read({**ctx, "on_card": False}) is None
    assert r.read({**ctx, "kind": "train"}) is None
    assert r.read({**ctx, "trace": None}) is None
    assert r.read({**ctx, "traced_units": 0}) is None
    gemm = {k: v for k, v in OPS.items() if "gemm" in k}
    assert r.read({**ctx, "trace": {"ops": gemm}}) is None
