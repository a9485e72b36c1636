"""A (forward, args) pair of the model's render forward at tiny shapes, and
the multi-device dry run.

Counterpart of __graft_entry__.py (its `entry` and `dryrun_multichip`):

    entry(device=None) -> (forward, (state, rays_o, rays_d))

forward(state, rays_o, rays_d) -> (rgb, depth, acc) renders 256 rays from
(0, 0, 4) through the hash-encoded NeRFSmall's coarse and fine passes
(ModelConfig(N_importance=16, log2_hashmap_size 14, finest_res 128),
RenderConfig(N_samples=32, N_importance=16, perturb=False), near 2, far 6,
the box +-1.5), on the card unless device names another. Rendering is
deterministic (no perturbation, no noise), so JAX's PRNG key of the
forward has no counterpart. `dryrun_multichip` is parallel/dryrun.py's.

    python -m hashnerf_torch.graft_entry [--device cpu|cuda]
"""
from __future__ import annotations

import argparse

import torch

from hashnerf_torch.parallel.dryrun import dryrun_multichip  # noqa: F401  (re-exported)

N_RAYS = 256
NEAR, FAR = 2.0, 6.0
BBOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def entry(device=None):
    """(forward, (state, rays_o, rays_d)): the model from generator seed 0,
    the rays' directions from seed 1 (JAX draws them from PRNGKey(1)
    beside the model's PRNGKey(0))."""
    from hashnerf_torch import resolve_device
    from hashnerf_torch.models.factory import ModelConfig, NGPState, query_fn
    from hashnerf_torch.ops.hash_encoding import HashGridConfig
    from hashnerf_torch.render.renderer import RenderConfig, render_rays

    device = resolve_device(device)
    cfg = ModelConfig(N_importance=16,
                      hash_grid=HashGridConfig(log2_hashmap_size=14, finest_resolution=128))
    rcfg = RenderConfig(N_samples=32, N_importance=16, perturb=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = NGPState(cfg, gen, device)
    bbox = torch.tensor(BBOX, dtype=torch.float32, device=device)

    def forward(state, rays_o, rays_d):
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        ret = render_rays(state, query_fn, rays_o, rays_d, viewdirs, NEAR, FAR, bbox, rcfg)
        return ret["rgb_map"], ret["depth_map"], ret["acc_map"]

    gen.manual_seed(1)
    rays_d = torch.randn((N_RAYS, 3), generator=gen, device=device)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = torch.zeros((N_RAYS, 3), device=device) + torch.tensor([0.0, 0.0, 4.0], device=device)
    return forward, (state, rays_o, rays_d)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    o = ap.parse_args()
    fwd, fargs = entry(o.device)
    with torch.no_grad():
        rgb, depth, acc = fwd(*fargs)
    print(f"entry OK: rgb {tuple(rgb.shape)}, finite {bool(torch.isfinite(rgb).all())}, "
          f"depth mean {float(depth.mean()):.4f}, acc mean {float(acc.mean()):.4f}")
