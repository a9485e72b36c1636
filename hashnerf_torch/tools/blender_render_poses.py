"""The blender spherical render path, drawn in 3-D.

Counterpart of hashnerf_tpu/tools/blender_render_poses.py: the 40 poses of
data/pose_paths.py::spherical_render_poses as frustums
(tools/pose_visualizer.py), the first in red. A host plot (matplotlib).

    python -m hashnerf_torch.tools.blender_render_poses OUT.png [--n 40]
"""
from __future__ import annotations

import argparse

from hashnerf_torch.data.pose_paths import spherical_render_poses
from hashnerf_torch.tools.pose_visualizer import CameraPoseVisualizer


def plot_render_path(out: str, n: int = 40) -> str:
    viz = CameraPoseVisualizer(xlim=(-5, 5), ylim=(-5, 5), zlim=(-5, 5))
    for i, p in enumerate(spherical_render_poses(n)):
        viz.add_pose(p, color="tab:blue" if i else "tab:red")
    viz.save(out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="the PNG to write")
    ap.add_argument("--n", type=int, default=40)
    o = ap.parse_args()
    print(plot_render_path(o.out, o.n))
