"""Multi-process bring-up smoke: two ranks over torch.distributed.

Counterpart of hashnerf_tpu/tools/multihost_smoke.py: the code a multi-host
launch runs (process-group bring-up, parallel/mesh.py; a (data, model) =
(2, 1) layout from make_dcn_mesh; the global batch split over the data
axis; two data-parallel train steps: loss, all-reduced gradients, RAdam)
in two processes, on the card unless --device names another: NCCL with
one card a process where there are two cards, else gloo ranks sharing
card 0; gloo on the CPU with --device cpu.

    python -m hashnerf_torch.tools.multihost_smoke [--device cpu|cuda] [--out FILE]

Prints {ok, loss, n_processes, n_global_devices, layout, device, backend}
and writes it to FILE when given.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

N_PROC = 2


def rank_main(rank: int, world: int, device):
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import make_dcn_mesh
    from hashnerf_torch.parallel.train_sharded import make_sharded_train_step
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    layout = make_dcn_mesh(world, model_per_host=1)
    args = config_parser().parse_args([])
    args.N_rand, args.N_samples, args.N_importance = 32, 8, 8
    args.finest_res, args.log2_hashmap_size, args.use_viewdirs, args.lrate = 32, 10, True, 0.01
    scene = make_synthetic_scene(H=16, W=16, n_train=2, n_test=1)
    t = Trainer(args, scene, device=device)
    loss_fn = make_loss_fn(args, t.render_cfg, t.bbox, t.model_cfg, hwf=scene.hwf)
    step = make_sharded_train_step(layout, loss_fn, t.optimizer, t.render_cfg)

    # the same global batch on every process (one seed), split over 'data'
    rng = np.random.default_rng(0)
    R = args.N_rand
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    batch = {"rays_o": np.zeros((R, 3), np.float32) + np.array([0, 0, 4], np.float32),
             "rays_d": d, "viewdirs": d, "target": rng.uniform(size=(R, 3)).astype(np.float32),
             "near": np.full((R,), 2.0, np.float32), "far": np.full((R,), 6.0, np.float32)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    for _ in range(2):
        m = step(t.state, batch, 1e-6, generator=t.generator)
    return {"loss": float(m["loss"]), "layout": layout.axes}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    ap.add_argument("--out", default=None, help="also write the record to this JSON file")
    opts = ap.parse_args(argv)
    from hashnerf_torch import resolve_device
    from hashnerf_torch.parallel.mesh import launch, world_backend

    device = resolve_device(opts.device)
    backend = world_backend(N_PROC, device)
    res = launch(rank_main, N_PROC, device, backend=backend)
    loss = res[0]["loss"]
    rec = {"ok": bool(np.isfinite(loss) and all(r["loss"] == loss for r in res)),
           "loss": loss, "n_processes": N_PROC, "n_global_devices": N_PROC,
           "layout": res[0]["layout"], "device": str(device), "backend": backend}
    print(json.dumps(rec), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
