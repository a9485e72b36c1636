"""chip_smoke.py's llff view gate (view_gate, hold_view_stages) and its
failure file (save_view_failure, replay_view; tests/view_replay.py for
JAX), on the CPU, on the JAX fixture's state and view
(tests/golden/jax_smoke_ckpt, 64 x 64 rays, 16 + 8 samples). Two states
whose weights differ by 3e-7 of themselves, as
test_torch_jax_ckpt.py::test_view_tolerance_admits_last_bits_and_refuses_a_fresh_state
makes them, stand for the card and the CPU."""
import copy
import os
import sys

import numpy as np
import jax  # noqa: F401  (JAX on the CPU, as conftest.py sets it)
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from test_torch_jax_ckpt import FIXTURE, _fixture_trainer  # noqa: E402

STRIDE = 1  # every row of the 64 x 64 view is held (the phase holds every 8th of 378)


def _moved(state, scale: float, params=None):
    """A copy of state whose parameters (all, or `params` of
    named_parameters) are each multiplied by 1 + scale * N(0, 1), seed 0."""
    from hashnerf_torch.models.factory import NGPState

    other = NGPState(state.cfg, device="cpu")
    other.load_state_dict(state.state_dict())
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in other.named_parameters():
            if params is None or name.startswith(params):
                p.mul_(1 + scale * torch.randn(p.shape, generator=g))
    return other


def _view(tt, c2w):
    from hashnerf_torch.ops.rays import get_rays

    sc = tt.scene
    ro, rd = get_rays(sc.H, sc.W, torch.as_tensor(sc.K), torch.as_tensor(np.asarray(c2w)[:3, :4]))
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    strided = (torch.arange(0, sc.H, STRIDE)[:, None] * sc.W + torch.arange(sc.W)).flatten()
    return (ro, rd, rd / torch.linalg.norm(rd, dim=-1, keepdim=True)), strided


@pytest.fixture(scope="module")
def fixture():
    tt, view = _fixture_trainer()
    assert tt.try_restore(FIXTURE)
    rays, strided = _view(tt, view["c2w"])
    return tt, rays, strided


def _gate(tt, rays, strided, other, **kw):
    return cs.view_gate(torch, np, tt.state, rays, tt.bbox, tt.render_cfg.eval_mode(), tt.near,
                        tt.far, 1024, strided, cpu_state=other, **kw)


@pytest.fixture(scope="module")
def last_bits(fixture):
    tt, rays, strided = fixture
    return _gate(tt, rays, strided, _moved(tt.state, 3e-7))


def test_gate_passes_states_apart_in_their_last_bits(last_bits):
    """Weights 3e-7 apart move single pixels by more than the fine pass's
    element-wise tolerance (the calibration test's 2.9e-4). The gate
    passes: every sample_pdf decision that the two states take apart is
    within rounding, and it lists them; the pixel that moves most does so
    without a flip, through a sample placed in a bin of little mass (a
    denominator of 6.7e-5), which carries the cdf's last bits into the
    placement 1 / denom times over, as placement_tolerance allows."""
    ok, rec, parts = last_bits
    assert ok, rec
    assert not any(rec["failing"].values()), rec["failing"]
    assert rec["flips"] > 0 and rec["flips"] == rec["flips_within_rounding"], rec
    assert rec["card_vs_cpu"]["max_abs_err"] > 1e-4, rec["card_vs_cpu"]
    assert rec["rays"] == parts["sel"].numel() == rec["strided_rays"] == 64 * 64 // STRIDE
    card, cpu = parts["card"], parts["cpu"]
    r = int((card["fine"]["rgb"] - cpu["fine"]["rgb"]).abs().amax(dim=-1).argmax())
    flipped, _, _ = cs.pdf_flips(torch, card, cpu)
    dz = (card["sample_pdf"]["z"][r] - cpu["sample_pdf"]["z"][r]).abs()
    s = int(dz.argmax())
    assert not bool(flipped[r].any()) and float(dz[s]) > 1e-3
    assert float(card["sample_pdf"]["denom"][r, s]) < 1e-4
    assert bool((dz <= cs.placement_tolerance(torch, card, cpu)[r]).all())


def _quiet_ray(parts):
    """A held ray whose margins are wide (over 1000 ulps at every step
    function) and whose samples the two states place alike."""
    same = (parts["card"]["sample_pdf"]["z"] == parts["cpu"]["sample_pdf"]["z"]).all(dim=-1)
    least = parts["margins"]["least"][parts["sel"]]
    quiet = (same & (least > 1000)).nonzero().flatten()
    assert quiet.numel()
    return int(quiet[0])


def _inject_raw(st, r):
    st["fine"]["raw"][r, :, 0] += 1e-2


def _inject_z(st, r):
    st["sample_pdf"]["z"][r, 3] += 1e-2


def _inject_rgb(st, r):
    st["fine"]["rgb"][r] += 3e-3


@pytest.mark.parametrize("inject, fails", [(_inject_raw, "fine_raw_at_card_z"),
                                           (_inject_z, "placement"),
                                           (_inject_rgb, "whole_rgb")],
                         ids=["fine_raw", "fine_z", "rgb"])
def test_gate_fails_on_an_unexplained_difference(last_bits, inject, fails):
    """On the passing pair, one difference injected into the card's stages
    of one ray placed alike by both, with wide margins: a fine
    raw channel moved by 1e-2, one sample moved by 1e-2, or its rgb by
    3e-3. The gate fails at that stage, on that ray alone."""
    _, _, parts = last_bits
    r = _quiet_ray(parts)
    card = copy.deepcopy(parts["card"])
    inject(card, r)
    ok, rec, bad = cs.hold_view_stages(torch, np, card, parts["cpu"], parts["at_card"])
    assert not ok and rec["failing"][fails] == 1, rec["failing"]
    assert bad.tolist() == [r]


def test_failure_file_replays_the_difference(fixture, tmp_path):
    """A CPU state whose fine net moved by 1e-2 of itself fails the gate;
    its file holds the state (the table's rows that the saved rays read),
    the rays and each render's stages. Replayed through the port's CPU
    route it gives back the saved CPU render and the same failure; through
    JAX (tests/view_replay.py) the same render at the tolerances that hold
    the port to JAX."""
    import view_replay

    tt, rays, strided = fixture
    path = str(tmp_path / "view_failure.pt")
    ok, rec, parts = _gate(tt, rays, strided, _moved(tt.state, 1e-2, params="fine."),
                           save_to=path)
    assert not ok and rec["saved"] == path and os.path.exists(path)
    rep = cs.replay_view(torch, path)
    saved = rep["saved"]
    n = min(int(parts["bad"].numel()), cs.VIEW_SAVE_RAYS)
    assert saved["saved_view_idx"].numel() == n
    assert saved["failing_view_idx"].numel() == parts["bad"].numel()
    assert set(saved["failing_view_idx"].tolist()) == set(parts["sel"][parts["bad"]].tolist())
    cpu_saved = saved["stages"]["cpu"]
    for stage in ("coarse", "fine"):
        for k in ("raw", "weights", "rgb"):
            np.testing.assert_allclose(rep["cpu"][stage][k].numpy(), cpu_saved[stage][k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{stage} {k}")
    ok_r, rec_r, bad_r = rep["hold"]
    assert not ok_r and bad_r.tolist() == list(range(n)), rec_r["failing"]
    card = saved["stages"]["card"]
    np.testing.assert_allclose((card["fine"]["rgb"] - rep["cpu"]["fine"]["rgb"]).numpy(),
                               (card["fine"]["rgb"] - cpu_saved["fine"]["rgb"]).numpy(), atol=1e-6)

    jx = view_replay.jax_stages(saved)
    np.testing.assert_allclose(jx["coarse"]["rgb"], rep["cpu"]["coarse"]["rgb"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jx["coarse"]["weights"], rep["cpu"]["coarse"]["weights"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jx["render_rays"]["rgb0"], jx["coarse"]["rgb"], rtol=1e-6, atol=1e-7)
    assert cs.jax_view_close(jx["render_rays"]["rgb_map"], jx["fine"]["rgb"])[0]
    ok_j, err_j = cs.jax_view_close(rep["cpu"]["fine"]["rgb"].numpy(), jx["fine"]["rgb"])
    assert ok_j, err_j
