"""A model family for the tests, brought to nerfbench as one file: the
port's classic NeRF (models/nerf.py::NeRF) with its positional encodings
off (--i_embed -1 --i_embed_views -1), so the points and the view
directions go in as they are, trained with Adam over one group.

test_nb_family.py copies it to families/toynerf.py of a folder laid out
as nerfbench/ is. Its plain reference takes the rays, sampling and
compositing of nerfbench/reference.py and writes out the NeRF MLP (D x W
trunk with biases, the skip concatenation, the view branch) and Adam in
optax's order, the port's (train/adam.py). It has no table: no encode
grid, no TV. Like every family it imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from nerfbench import counts, reference as refm

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def layer_shapes(s: dict) -> Dict[str, tuple]:
    """(out, in) of one net's layers under use_viewdirs, over 3 point and 3
    view inputs: the trunk (after each layer in skips the points are
    concatenated back in), then feature, alpha, the view layer, rgb."""
    D, W = s["netdepth"], s["netwidth"]
    skips = tuple(s.get("skips", (4,)))
    out = {"pts.0": (W, 3)}
    for i in range(D - 1):
        out[f"pts.{i + 1}"] = (W, W + 3 if i in skips else W)
    out.update({"feature": (W, W), "alpha": (1, W), "views.0": (W // 2, W + 3), "rgb": (3, W // 2)})
    return out


def nets(s: dict) -> List[str]:
    return ["coarse"] + (["fine"] if s["N_importance"] > 0 and not s.get("share_fine") else [])


def initial_weights(s: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), made on
    the device from the seed, one draw a tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for net in nets(s):
        for name, (o, i) in layer_shapes(s).items():
            bound = 1.0 / math.sqrt(i)
            for leaf, shape in (("weight", (o, i)), ("bias", (o,))):
                out[f"{net}.{name}.{leaf}"] = torch.empty(
                    shape, dtype=torch.float32, device=device).uniform_(-bound, bound, generator=gen)
    return out


def program_leaves(trainer) -> Dict[str, torch.nn.Parameter]:
    """The program's trained tensors by the reference's names."""
    out = {}
    for net in ("coarse", "fine"):
        mod = getattr(trainer.state, net)
        if mod is None:
            continue
        layers = {f"pts.{i}": lin for i, lin in enumerate(mod.pts_linears)}
        layers.update({"feature": mod.feature_linear, "alpha": mod.alpha_linear,
                       "rgb": mod.rgb_linear})
        layers.update({f"views.{i}": lin for i, lin in enumerate(mod.views_linears)})
        for name, lin in layers.items():
            out[f"{net}.{name}.weight"] = lin.weight
            out[f"{net}.{name}.bias"] = lin.bias
    return out


def step_groups(names: List[str]) -> Dict[str, List[str]]:
    """Adam's one group."""
    return {"net": list(names)}


def grid(s: dict) -> None:
    """No table, so no encode to count."""
    return None


def macs_per_point(s: dict) -> int:
    return sum(o * i for o, i in layer_shapes(s).values())


def train_flops_per_step(s: dict) -> float:
    return counts.train_flops(s, macs_per_point(s), 0)


def render_flops_per_frame(s: dict, H: int, W: int) -> float:
    return counts.render_flops(s, H, W, macs_per_point(s))


def mlp(w: Dict[str, torch.Tensor], x, views, s: dict, dtype: Optional[torch.dtype]):
    """One net: x (N, 3), views (N, 3) -> (N, 4) = [rgb logits, alpha]."""
    def lin(h, name):
        wt, b = w[name + ".weight"], w[name + ".bias"]
        if dtype is None:
            return F.linear(h, wt, b)
        return F.linear(h.to(dtype).float(), wt.to(dtype).float(), b)

    skips = tuple(s.get("skips", (4,)))
    h = x
    for i in range(s["netdepth"]):
        h = torch.relu(lin(h, f"pts.{i}"))
        if i in skips:
            h = torch.cat([x, h], -1)
    alpha = lin(h, "alpha")
    h = torch.relu(lin(torch.cat([lin(h, "feature"), views], -1), "views.0"))
    return torch.cat([lin(h, "rgb"), alpha], -1)


class Reference(refm.Reference):
    """nerfbench's reference with this family's field and optimizer."""

    def __init__(self, s: dict, scene: dict, device, dtype: Optional[torch.dtype] = "config",
                 half_batch: bool = False):
        self.s, self.sc, self.device = s, scene, device
        if dtype == "config":
            cd = s.get("compute_dtype") or "float32"
            dtype = None if cd == "float32" else getattr(torch, cd)
        self.dtype = dtype
        self.half_batch = half_batch
        self.share = bool(s.get("share_fine")) or s["N_importance"] == 0

    def query(self, p, pts, viewdirs, fine: bool):
        R, S = pts.shape[0], pts.shape[1]
        net = "coarse" if (self.share or not fine) else "fine"
        w = {k[len(net) + 1:]: v for k, v in p.items() if k.startswith(net + ".")}
        views = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        return mlp(w, pts.reshape(-1, 3), views, self.s, self.dtype).reshape(R, S, 4)

    def tv(self, p, gen):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def radam(self, p, st, grads):
        """train_steps' optimizer step, here Adam as optax computes it: the
        moments, then p += m_hat / (sqrt(v_hat) + eps) * -lr(t - 1)."""
        s = self.s
        with torch.no_grad():
            step = st["step"]["net"]
            for n in p:
                gr = grads[n]
                st["m"][n].mul_(BETA1).add_(gr * (1 - BETA1))
                g2 = gr * gr
                g2.mul_(1 - BETA2)
                st["v"][n].mul_(BETA2).add_(g2)
            lr = s["lrate"] * torch.pow(0.1, step / torch.full_like(step, float(s["lrate_decay"] * 1000)))
            t = step + 1.0
            bias1 = 1.0 - torch.pow(torch.full_like(t, BETA1), t)
            bias2 = 1.0 - torch.pow(torch.full_like(t, BETA2), t)
            for n in p:
                denom = torch.sqrt(st["v"][n] / bias2) + EPS
                p[n].add_(st["m"][n] / bias1 / denom * (-lr))
            st["step"]["net"] = step + 1.0
