"""The multi-device modes on N ranks, at a tiny size: a dry run.

Counterpart of __graft_entry__.py::dryrun_multichip:
  1. data parallelism on the per-ray culled flagship (packed tables, bf16
     MLPs, aabb_clip, per-ray culling: every per-ray op is local to a
     rank's rays, so only the gradients cross);
  2. data parallelism on the global-culled flagship (the tpu-fast
     preset's block-8 culling: one cut over the whole batch, each rank
     querying its share of the kept blocks), as JAX's DP flagship mode;
  3. the level-sharded table on a (2, N/2) layout (N >= 4 and even);
  4. ZeRO-1 with a bf16 wire, its loss held against the one-device step
     within 5% (the forward sees the bf16-rounded parameters).

    python -m hashnerf_torch.parallel.dryrun [N] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.txt")
TINY = ["--N_samples", "8", "--N_importance", "8", "--log2_hashmap_size", "10",
        "--finest_res", "32"]
FLAGSHIP = ["--n_levels", "4", "--n_features_per_level", "8", "--packed_layout",
            "--log2_blocks", "9", "--share_fine", "--compute_dtype", "bfloat16", "--aabb_clip",
            "--use_occupancy", "--occ_per_ray", "--occ_keep_fraction", "0.25",
            "--occ_keep_coarse", "0.5", "--occ_warmup", "0", "--occ_update_every", "1"]
# the tpu-fast preset's culling (block 8, adaptive updates) in place of the
# per-ray culling, at these sizes
GLOBAL = [f for f in FLAGSHIP if f != "--occ_per_ray"] + ["--occ_block", "8",
                                                          "--occ_adaptive_update"]


def _rank(rank: int, world: int, device):
    import torch

    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_mesh
    from hashnerf_torch.parallel.table_sharded import make_table_mesh, make_table_sharded_trainer
    from hashnerf_torch.parallel.train_sharded import (
        init_dp_zero, make_dp_zero_train_step, rank_generator,
    )
    from hashnerf_torch.train.config import parse_args
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    def args_of(*flags):
        return parse_args(["--config", SMOKE, "--N_rand", str(16 * world), "--device", str(device),
                           *TINY, *flags])

    scene = make_synthetic_scene(H=32, W=32, n_train=4, n_test=1)
    out = {}
    # 1. data parallelism on the per-ray flagship: one step fills the grid,
    # the second culls
    t = Trainer(args_of(*FLAGSHIP, "--num_devices", str(world)), scene, device=device)
    for _ in range(2):
        m = t.step(t.sample_batch(False))
    out["dp_per_ray"] = {"loss": float(m["loss"]), "keeps": t.last_occ_keep}

    # 2. data parallelism on the global-culled flagship, likewise
    t = Trainer(args_of(*GLOBAL, "--num_devices", str(world)), scene, device=device)
    for _ in range(2):
        m = t.step(t.sample_batch(False))
    out["dp_global"] = {"loss": float(m["loss"]), "keeps": t.last_occ_keep}

    # 3. the level-sharded table on (2, N/2)
    if world >= 4 and world % 2 == 0:
        layout = make_table_mesh(2, world // 2)
        ts = make_table_sharded_trainer(layout, args_of("--n_levels", "8"), scene, device=device,
                                        seed=1)
        m = ts.step(ts.sample_batch(False))
        out["table_sharded"] = {"loss": float(m["loss"]), "layout": [2, world // 2]}

    # 4. ZeRO-1, bf16 wire, deterministic rendering, against one device
    args = args_of("--perturb", "0", "--raw_noise_std", "0", "--tv-loss-weight", "0")
    t = Trainer(args, scene, device=device)
    batch = t.sample_image(int(scene.i_train[0]), args.N_rand, False)
    layout = make_mesh(world)
    loss_fn = make_loss_fn(args, t.render_cfg, t.bbox, t.model_cfg, with_tv=False, hwf=scene.hwf)
    master, opt = init_dp_zero(layout, t.state, args)
    step = make_dp_zero_train_step(layout, loss_fn, t.state)
    z = float(step(master, opt, batch, 0.0, rank_generator(0, layout, device))["loss"])
    ref = Trainer(args, scene, device=device)
    ref_loss = float(ref.step(batch)["loss"])
    if not abs(z - ref_loss) <= 0.05 * max(abs(ref_loss), 1e-3):
        raise AssertionError(f"ZeRO-1 loss {z} vs one device {ref_loss}")
    out["zero_bf16"] = {"loss": z, "one_device_loss": ref_loss}
    for k, v in out.items():
        if not np.isfinite(v["loss"]):
            raise AssertionError(f"{k}: loss {v['loss']}")
    torch.distributed.barrier()
    return out


def dryrun_multichip(n_devices: int, device=None):
    """Run the modes on n_devices ranks, on the card unless device names
    another (hashnerf_torch.resolve_device: with no card and no device
    named this raises): gloo on the CPU, NCCL on as many cards, gloo ranks
    sharing card 0 where the cards are fewer (parallel/mesh.py::world_backend).
    Returns rank 0's {mode: {loss, ...}} and prints a line a mode."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.parallel.mesh import launch, world_backend

    device = resolve_device(device)
    res = launch(_rank, n_devices, device, backend=world_backend(n_devices, device))[0]
    for mode, r in res.items():
        print(f"dryrun_multichip OK: {mode} on {n_devices} ranks ({device}): {r}", flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    o = ap.parse_args()
    dryrun_multichip(o.n, o.device)
