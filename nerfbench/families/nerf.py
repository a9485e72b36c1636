"""The "nerf" model family: the classic NeRF of Mildenhall et al., "NeRF:
Representing Scenes as Neural Radiance Fields for View Synthesis" (ECCV
2020, arXiv:2003.08934, sec. 5 and Fig. 7), as nerf-pytorch's
configs/lego.txt trains it, with Adam over one group and no table.

Its plain reference takes the rays, sampling and compositing of
nerfbench/reference.py and writes out the rest op by op, in float32 with
TF32 off: the positional encoding of the points and the view directions,
the D x W trunk with biases and the skip concatenation, the view branch,
and Adam in optax's order. Like every family it imports nothing of the
program; it reads the program's trainer by its attributes alone.

Where it departs from the paper, as nerf-pytorch (and the port) do:
  * the encoding leaves out the paper's pi: sin(2^k x) and cos(2^k x) for
    k = 0 .. multires - 1, and keeps x itself in front, so a point takes
    3 + 6 * 10 = 63 inputs and a view direction 3 + 6 * 4 = 27;
  * nerf-pytorch's layer order: after trunk layer i in `skips` (0-based,
    4) the encoded points are concatenated in front of the activations,
    [x, h]; alpha and the 256-wide feature are two separate linear layers
    on the trunk's output, the feature without an activation; the view
    branch is [feature, view encoding] -> 128 (ReLU) -> rgb;
  * Adam with eps 1e-8 (the paper's is 1e-7), bias-corrected as optax does
    it, and the learning rate lrate * 0.1^(t / (lrate_decay * 1000));
  * the loss adds HashNeRF-pytorch's entropy sparsity term at
    sparse_loss_weight (1e-10), as the port's does for every model.
Both encodings are positional (the port's --i_embed 0 --i_embed_views 0).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from nerfbench import reference as refm

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
# float32 products in float32 on the card, not TF32 (as the port sets them;
# nerfbench.control turns TF32 on around its control's calls alone)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def positional(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(m-1) x), cos(2^(m-1) x)]:
    3 + 6 * multires inputs a 3-vector."""
    parts = [x]
    for k in range(multires):
        xf = x * (2.0 ** k)
        parts += [torch.sin(xf), torch.cos(xf)]
    return torch.cat(parts, -1)


def layer_shapes(s: dict, fine: bool = False) -> Dict[str, tuple]:
    """(out, in) of one net's layers under use_viewdirs: the trunk (after
    each layer in skips the encoded points are concatenated back in), then
    feature, alpha, the view layer, rgb."""
    D = s["netdepth_fine"] if fine else s["netdepth"]
    W = s["netwidth_fine"] if fine else s["netwidth"]
    skips = tuple(s.get("skips", (4,)))
    cx, cv = 3 + 6 * s["multires"], 3 + 6 * s["multires_views"]
    out = {"pts.0": (W, cx)}
    for i in range(D - 1):
        out[f"pts.{i + 1}"] = (W, W + cx if i in skips else W)
    out.update({"feature": (W, W), "alpha": (1, W), "views.0": (W // 2, W + cv), "rgb": (3, W // 2)})
    return out


def nets(s: dict) -> List[str]:
    return ["coarse"] + (["fine"] if s["N_importance"] > 0 and not s.get("share_fine") else [])


def initial_weights(s: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (nn.Linear's
    bound), made on the device from the seed, one draw a tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for net in nets(s):
        for name, (o, i) in layer_shapes(s, net == "fine").items():
            bound = 1.0 / math.sqrt(i)
            for leaf, shape in (("weight", (o, i)), ("bias", (o,))):
                out[f"{net}.{name}.{leaf}"] = torch.empty(
                    shape, dtype=torch.float32, device=device).uniform_(-bound, bound, generator=gen)
    return out


def program_leaves(trainer) -> Dict[str, torch.nn.Parameter]:
    """The program's trained tensors by the reference's names: pts_linears,
    feature_linear, alpha_linear, views_linears and rgb_linear, weights and
    biases, of each net."""
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


def macs_per_point(s: dict, fine: bool = False) -> int:
    """A net's multiply-adds a point: 593,408 at D 8, W 256, 63 / 27 inputs."""
    return sum(o * i for o, i in layer_shapes(s, fine).values())


def _pass_points(s: dict) -> Dict[bool, int]:
    """Points a ray queries of each net (fine: False / True): N_samples of
    the coarse net, N_samples + N_importance of the fine one."""
    Ns, Ni = s["N_samples"], s["N_importance"]
    if Ni == 0:
        return {False: Ns}
    if s.get("share_fine"):
        return {False: 2 * Ns + Ni}
    return {False: Ns, True: Ns + Ni}


def train_flops_per_step(s: dict) -> float:
    """2 FLOPs a multiply-add, x3 for forward and both backward products,
    over every sample of both passes of N_rand rays."""
    return 6.0 * s["N_rand"] * sum(macs_per_point(s, f) * n for f, n in _pass_points(s).items())


def train_gemm_flops_per_step(s: dict) -> float:
    """The FLOPs the training GEMMs compute a step: train_flops_per_step
    less the input-gradient product of each net's first layer, which no
    GEMM computes, since the encoded points take no gradient."""
    first = sum(math.prod(layer_shapes(s, f)["pts.0"]) * n for f, n in _pass_points(s).items())
    return train_flops_per_step(s) - 2.0 * s["N_rand"] * first


def render_flops_per_frame(s: dict, H: int, W: int) -> float:
    """Exact eval, forward only: every sample of both passes of every
    pixel's ray."""
    return 2.0 * H * W * sum(macs_per_point(s, f) * n for f, n in _pass_points(s).items())


def mlp(w: Dict[str, torch.Tensor], x, views, s: dict, dtype: Optional[torch.dtype]):
    """One net: x (N, cx) encoded points, views (N, cv) encoded directions
    -> (N, 4) = [rgb logits, alpha]. With dtype, each layer's input and
    weight are rounded to it and multiplied in float32."""
    def lin(h, name):
        wt, b = w[name + ".weight"], w[name + ".bias"]
        if dtype is None:
            return F.linear(h, wt, b)
        return F.linear(h.to(dtype).float(), wt.to(dtype).float(), b)

    skips = tuple(s.get("skips", (4,)))
    D = sum(1 for k in w if k.startswith("pts.") and k.endswith(".weight"))
    h = x
    for i in range(D):
        h = torch.relu(lin(h, f"pts.{i}"))
        if i in skips:
            h = torch.cat([x, h], -1)
    alpha = lin(h, "alpha")
    h = torch.relu(lin(torch.cat([lin(h, "feature"), views], -1), "views.0"))
    return torch.cat([lin(h, "rgb"), alpha], -1)


class Reference(refm.Reference):
    """nerfbench's reference with this family's field and optimizer.

    `dtype` rounds the MLP operands (None: float32 products, or the
    configuration's compute_dtype); `half_batch` takes each image loss
    over the first half of the rays only (a planted fault)."""

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
        s = self.s
        R, S = pts.shape[0], pts.shape[1]
        net = "coarse" if (self.share or not fine) else "fine"
        w = {k[len(net) + 1:]: v for k, v in p.items() if k.startswith(net + ".")}
        x = positional(pts.reshape(-1, 3), s["multires"])
        dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
        views = positional(dirs, s["multires_views"])
        return mlp(w, x, views, s, self.dtype).reshape(R, S, 4)

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
