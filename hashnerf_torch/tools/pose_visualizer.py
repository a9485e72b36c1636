"""3-D camera frustums of a transforms.json pose set.

Counterpart of hashnerf_tpu/tools/pose_visualizer.py: each camera is a
pyramid, its apex at the camera's centre. The geometry is frustum_faces (a
numpy function); CameraPoseVisualizer draws it with matplotlib, imported
when a figure is made (a host plot).

    python -m hashnerf_torch.tools.pose_visualizer TRANSFORMS.json OUT.png
"""
from __future__ import annotations

import argparse
import json
from typing import List

import numpy as np


def frustum_faces(c2w, focal_scale: float = 0.3, aspect: float = 0.25) -> List[np.ndarray]:
    """The pyramid of camera c2w ((3 | 4, 4)) in world coordinates: four
    triangles (apex, corner, next corner) and the far quad, each an (n, 3)
    array of its vertices."""
    c2w = np.asarray(c2w, dtype=np.float64)
    w = aspect
    corners_cam = np.array([[0, 0, 0, 1], [w, w, -focal_scale, 1], [w, -w, -focal_scale, 1],
                            [-w, -w, -focal_scale, 1], [-w, w, -focal_scale, 1]]).T
    m = np.eye(4)
    m[:3, :4] = c2w[:3, :4]
    pts = (m @ corners_cam).T[:, :3]
    return [pts[[0, 1, 2]], pts[[0, 2, 3]], pts[[0, 3, 4]], pts[[0, 4, 1]], pts[[1, 2, 3, 4]]]


class CameraPoseVisualizer:
    def __init__(self, xlim=(-5, 5), ylim=(-5, 5), zlim=(-5, 5)):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self.plt = plt
        self.fig = plt.figure(figsize=(8, 8))
        self.ax = self.fig.add_subplot(projection="3d")
        self.ax.set_xlim(xlim)
        self.ax.set_ylim(ylim)
        self.ax.set_zlim(zlim)
        self.ax.set_xlabel("x")
        self.ax.set_ylabel("y")
        self.ax.set_zlabel("z")

    def add_pose(self, c2w, color="tab:blue", focal_scale=0.3, aspect=0.25):
        """Draw one camera's frustum_faces."""
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        self.ax.add_collection3d(Poly3DCollection(
            frustum_faces(c2w, focal_scale, aspect), facecolors=color, linewidths=0.3,
            edgecolors=color, alpha=0.25))

    def save(self, path: str):
        self.fig.savefig(path, bbox_inches="tight", dpi=120)
        self.plt.close(self.fig)


def visualize_transforms(transforms_path: str, out: str) -> str:
    """Every frame's camera of a transforms.json, written to out."""
    with open(transforms_path) as f:
        meta = json.load(f)
    viz = CameraPoseVisualizer()
    for frame in meta["frames"]:
        viz.add_pose(np.array(frame["transform_matrix"]))
    viz.save(out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("transforms")
    ap.add_argument("out", help="the PNG to write")
    o = ap.parse_args()
    print(visualize_transforms(o.transforms, o.out))
