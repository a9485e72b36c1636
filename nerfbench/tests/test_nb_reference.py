"""The frozen plain reference against the port at a tiny size: one
training step (loss and every gradient) and one small render, on the CPU,
for both configurations. The yardstick computes the same mathematics."""
import numpy as np
import pytest
import torch

from nerfbench import control, harness
from nerfbench.tests.tiny import tiny_config, tiny_traffic

SEED = 2**32 + 77


@pytest.mark.parametrize("name", ["chair", "flagship"])
def test_one_step_and_one_render(name):
    cfg = tiny_config(name)
    trainer, sc, init, fam, _ = harness.build(cfg, SEED, "cpu")
    r = fam.Reference(cfg["settings"], sc, "cpu")
    gen = torch.Generator()
    gen.set_state(trainer.generator.get_state())
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    loss = r.loss(leaves, gen, precrop=True, tv=True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = trainer.step(trainer.sample_batch(True))
    assert abs(float(got["loss"]) - float(loss.detach())) <= 1e-6 * abs(float(loss.detach()))
    for (name_, g), p in zip(zip(leaves, grads), fam.program_leaves(trainer).values()):
        assert torch.allclose(p.grad, g, rtol=1e-4, atol=1e-9), name_
    with torch.no_grad():
        for k, p in fam.program_leaves(trainer).items():
            p.copy_(init[k])
    pose = sc["render_poses"][1]
    rgb = trainer.render_image(pose)[0]
    want = r.render_frame(init, torch.as_tensor(np.asarray(pose)[:3, :4], dtype=torch.float32),
                          sc["H"], sc["W"], chunk=50)
    assert float((rgb - want).abs().max()) < 1e-5


def test_the_flagship_control_fails_on_the_cpu():
    """float8 operands in the reference's place (the flagship's control)
    read far above what the program reads."""
    rec = control.read_seed(tiny_config("flagship"), tiny_traffic("train_steady"), SEED, "cpu",
                            check_frames=1, chunk=64)
    prog, ctrl = rec["program"], rec["control"]
    assert max(prog.values()) < 1e-5
    assert ctrl["grad.start"] > 0.1 and ctrl["rgb_mean_gap"] > 1e-3
    assert rec["half_batch"]["loss.trained"] > 1e-2


@pytest.mark.cuda
def test_the_controls_fail_on_the_card():
    """On the card at a reduced size: TF32 for the chair, float8 operands
    for the flagship, each against the float32 / bfloat16 reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in ("chair", "flagship"):
        rec = control.read_seed(tiny_config(name), tiny_traffic("train_steady"), SEED, "cuda",
                                check_frames=1, chunk=64)
        assert max(rec["control"].values()) > 10 * max(
            max(rec["program"].values()), 1e-7), (name, rec)
