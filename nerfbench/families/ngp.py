"""The "ngp" model family (a configuration's default): Instant-NGP's hash
grid (per corner, or the corner-packed layout) under HashNeRF-pytorch's
NeRFSmall, trained with RAdam over a net group and a table group.

Its plain reference is nerfbench/reference.py; this module names the
family's parts for the harness, the control and the counts. It reads the
program's trainer by its attributes and imports nothing of the program.
The reference has no NDC path: a scene that sets "ndc" is not for it.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from nerfbench import counts, reference as refm

BETA1 = refm.ADAM_BETAS[0]
Reference = refm.Reference
initial_weights = refm.initial_weights


def grid(s: dict) -> refm.Grid:
    """The encode's sizes."""
    return refm.Grid(s)


def program_leaves(trainer) -> Dict[str, torch.nn.Parameter]:
    """The program's trained tensors by the reference's names."""
    st = trainer.state
    out = {}
    if isinstance(st.hash_table, torch.nn.ParameterDict):
        for k, name in (("dense", "dense"), ("fine", "fine_table")):
            if k in st.hash_table:
                out[name] = st.hash_table[k]
    else:
        out["table"] = st.hash_table
    for net in ("coarse", "fine"):
        mod = getattr(st, net)
        if mod is None:
            continue
        for kind, layers in (("sigma", mod.sigma_net), ("color", mod.color_net)):
            for i, lin in enumerate(layers):
                out[f"{net}.{kind}.{i}"] = lin.weight
    return out


def step_groups(names: List[str]) -> Dict[str, List[str]]:
    """RAdam's groups, each with one step count: the nets, the table(s).
    The split must match the one `reference.Reference.radam` makes by
    `reference.is_table`, which is frozen."""
    return {"net": [n for n in names if not refm.is_table(n)],
            "table": [n for n in names if refm.is_table(n)]}


def macs_per_point(s: dict) -> int:
    """NeRFSmall's multiply-adds a point: 32*64 + 64*16 + 31*64 + 64*64 +
    64*3 = 9,344 over an encoding of 32 features."""
    return sum(o * i for o, i in refm.net_shapes(refm.Grid(s).out_dim))


def sigma_macs_per_point(s: dict) -> int:
    """A density query needs the sigma net alone: 32*64 + 64*16."""
    return sum(o * i for o, i in refm.net_shapes(refm.Grid(s).out_dim)[:2])


def train_flops_per_step(s: dict) -> float:
    return counts.train_flops(s, macs_per_point(s), sigma_macs_per_point(s))


def render_flops_per_frame(s: dict, H: int, W: int) -> float:
    return counts.render_flops(s, H, W, macs_per_point(s))
