"""Numpy copy of hashnerf_tpu/data/scene.py (the port imports nothing of
the JAX package): the Scene every loader returns, and st3d's RayBundle.

Uniform Scene container emitted by every loader.

The reference's six loaders return six divergent signatures
(run_nerf.py:210-299 unpacks each differently); here every loader emits one
struct so the trainer/renderer are dataset-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Scene:
    images: np.ndarray  # (N, H, W, 3) float32 in [0, 1]
    poses: np.ndarray  # (N, 3, 4) or (N, 4, 4) c2w
    render_poses: np.ndarray  # (M, 4, 4) demo path
    hwf: Tuple[int, int, float]
    K: np.ndarray  # (3, 3) intrinsics
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float
    far: float
    bounding_box: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (min(3,), max(3,))
    ndc: bool = False  # LLFF forward-facing path
    lindisp: bool = False
    # LINEMOD-style per-dataset K override already folded into K.

    @property
    def H(self) -> int:
        return int(self.hwf[0])

    @property
    def W(self) -> int:
        return int(self.hwf[1])

    @property
    def focal(self) -> float:
        return float(self.hwf[2])

    def bbox_array(self) -> np.ndarray:
        if self.bounding_box is None:
            # Fallback box from near/far frusta is dataset-specific; a unit-ish
            # box keeps hash encoding functional (deepvoxels/LINEMOD have no
            # bbox in the reference either — they are positional-encoding paths).
            return np.array([[-10.0, -10.0, -10.0], [10.0, 10.0, 10.0]], np.float32)
        return np.stack([self.bounding_box[0], self.bounding_box[1]], 0).astype(np.float32)



@dataclasses.dataclass
class RayBundle:
    """Flat per-ray training data of the st3d / OmniNeRF path."""

    o: np.ndarray  # (N, 3)
    d: np.ndarray  # (N, 3)
    rgb: np.ndarray  # (N, 3)
    depth: Optional[np.ndarray] = None  # (N,)
    g: Optional[np.ndarray] = None  # (N, 3) image-gradient target

    def shuffled(self, rng: np.random.Generator) -> "RayBundle":
        perm = rng.permutation(self.rgb.shape[0])
        pick = lambda a: None if a is None else a[perm]
        return RayBundle(self.o[perm], self.d[perm], self.rgb[perm], pick(self.depth), pick(self.g))
