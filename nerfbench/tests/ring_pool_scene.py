"""A scene kind for the tests, copied into a tree's scenes/ folder as
ring_pool.py: the ring scene's training views as a column pool, with no
images, as a panorama's loader gives its rays. "pool" holds rays_o, rays_d
and target of every pixel, in image, row, column order."""
import os

import torch

from nerfbench import reference, spec


@torch.no_grad()
def make_scene(sp: dict, device) -> dict:
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sc = spec.scene_of({"scene": {"kind": "ring"}}, base).make_scene(sp, device)
    N, H, W = sc["images"].shape[:3]
    ids = torch.arange(N * H * W, device=device)
    pix = ids % (H * W)
    rays_o, rays_d = reference.pixel_rays(sc["K"], sc["poses"].index_select(0, ids // (H * W)),
                                          pix // W, pix % W)
    return {"pool": {"rays_o": rays_o, "rays_d": rays_d, "target": sc["images"].reshape(-1, 3)},
            "H": H, "W": W, "near": sc["near"], "far": sc["far"], "bbox": sc["bbox"]}
