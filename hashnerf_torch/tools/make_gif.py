"""Stitch per-checkpoint render frames into an iteration-stamped GIF.

Counterpart of hashnerf_tpu/tools/make_gif.py: collect_frames walks the
renderonly_*_NNNNNN / testset_NNNNNN directories of a log directory (JAX's
regex and order) and takes the first PNG of each; each frame is read with
utils/png.py, stamped "iter N" at (8, 8) in (255, 64, 64), and the frames
are written by utils/io.py::write_gif. The stamp is drawn with a 5 x 7
bitmap font of this module, so that the tool needs neither PIL nor
imageio: its glyphs are not PIL's default font's (ROADMAP §C, deliberate
differences).

    python -m hashnerf_torch.tools.make_gif LOGDIR OUT.gif [--fps 4]
"""
from __future__ import annotations

import argparse
import os
import re
from typing import List, Tuple

import numpy as np

STAMP_XY = (8, 8)
STAMP_RGB = (255, 64, 64)
GLYPH_W, GLYPH_H, GLYPH_GAP = 5, 7, 1

# 5 x 7 glyphs, a row a string, '#' set
_GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"),
    "3": ("####.", "....#", "....#", ".###.", "....#", "....#", "####."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#", "....#", "#...#", ".###."),
    "6": (".###.", "#....", "#....", "####.", "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####", "....#", "....#", ".###."),
    "i": ("..#..", ".....", ".##..", "..#..", "..#..", "..#..", ".###."),
    "t": (".#...", ".#...", "####.", ".#...", ".#...", ".#..#", "..##."),
    "e": (".....", ".....", ".###.", "#...#", "#####", "#....", ".###."),
    "r": (".....", ".....", "#.##.", "##..#", "#....", "#....", "#...."),
    " ": (".....",) * 7,
}
_MASKS = {c: np.array([[ch == "#" for ch in row] for row in rows]) for c, rows in _GLYPHS.items()}


def stamp_box(text: str) -> Tuple[int, int, int, int]:
    """(y0, x0, y1, x1) of the pixels stamp may change."""
    x, y = STAMP_XY
    return y, x, y + GLYPH_H, x + len(text) * (GLYPH_W + GLYPH_GAP)


def stamp(img: np.ndarray, text: str) -> np.ndarray:
    """A copy of (H, W, 3) uint8 img with text drawn at STAMP_XY in
    STAMP_RGB (glyphs clipped at the image's edge)."""
    out = np.array(img, dtype=np.uint8, copy=True)
    H, W = out.shape[:2]
    y0, x = STAMP_XY
    for ch in text:
        m = _MASKS[ch][:max(0, H - y0), :max(0, W - x)]
        out[y0:y0 + m.shape[0], x:x + m.shape[1]][m] = STAMP_RGB
        x += GLYPH_W + GLYPH_GAP
    return out


def collect_frames(logdir: str) -> List[Tuple[int, str]]:
    """(iteration, first PNG) of each renderonly_*_NNNNNN / testset_NNNNNN
    directory of logdir, ordered by iteration."""
    entries = []
    for d in sorted(os.listdir(logdir)):
        m = re.match(r"(?:renderonly_\w+|testset)_(\d+)$", d)
        if not m:
            continue
        frame_dir = os.path.join(logdir, d)
        pngs = sorted(f for f in os.listdir(frame_dir) if f.endswith(".png"))
        if pngs:
            entries.append((int(m.group(1)), os.path.join(frame_dir, pngs[0])))
    return sorted(entries)


def make_gif(logdir: str, out: str, fps: int = 4) -> str:
    """Write the stamped frames of logdir to out; returns out. Raises
    FileNotFoundError when logdir has no frame."""
    from hashnerf_torch.utils.io import write_gif
    from hashnerf_torch.utils.png import read_png

    frames = []
    for it, path in collect_frames(logdir):
        img = read_png(path)
        rgb = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
        frames.append(stamp(rgb, f"iter {it}"))
    if not frames:
        raise FileNotFoundError(f"no render frames under {logdir}")
    if len({f.shape for f in frames}) > 1:
        raise ValueError(f"{logdir}: frames of different sizes {sorted({f.shape for f in frames})}")
    write_gif(out, np.stack(frames), fps=fps)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logdir")
    ap.add_argument("out", help="the GIF to write")
    ap.add_argument("--fps", type=int, default=4)
    o = ap.parse_args()
    print(make_gif(o.logdir, o.out, o.fps))
