"""Numerical guardrails: the HASHNERF_DEBUG=1 NaN/Inf scan.

Counterpart of hashnerf_tpu/utils/debug.py (the reference's DEBUG scan over
every map a render returns): `check_finite` walks a nested dict / list /
tuple / NamedTuple of tensors (or numpy arrays, or numbers) in the order
jax.tree_util flattens it (dict keys sorted) and prints JAX's message for
each leaf that holds a NaN or an Inf, its path spelt as jax.tree_util.keystr
spells it. `render` runs it on its outputs when debug_enabled(); when it is
off nothing runs, so a captured step is untouched.
"""
from __future__ import annotations

import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def debug_enabled() -> bool:
    return os.environ.get("HASHNERF_DEBUG", "0") not in ("0", "", "false")


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in jax.tree_util's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree: Any, where: str = "") -> bool:
    """Scan a tree for NaN/Inf; prints offenders, returns True when clean.
    Leaves that are not floating point are skipped."""
    clean = True
    for name, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if not leaf.is_floating_point():
                continue
            bad, size = int((~torch.isfinite(leaf)).sum()), leaf.numel()
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            bad, size = int((~np.isfinite(arr)).sum()), arr.size
        if bad:
            clean = False
            print(f"! [Numerical Error] {where}{name} contains {bad} nan/inf of {size}")
    return clean


class StageTap:
    """The tensors the render path hands out at its stages, for holding two
    devices' renders of the same rays against each other stage by stage
    (chip_smoke.py's llff view gate, chip_diag.py llff-view).

    render_rays(tap=) records "coarse" (z, raw, weights, rgb) and "fine"
    (z, raw, weights, rgb); sample_pdf(tap=) records "sample_pdf" (bins, u,
    cdf, inds, below, above, denom before its 1e-5 switch, and the samples
    z). Nothing is recorded unless a tap is passed.
    """

    def __init__(self):
        self.stages = {}

    def record(self, name: str, **tensors) -> None:
        self.stages[name] = {k: v.detach() for k, v in tensors.items()}
