"""Run artifacts: experiment args, loss history, the PSNR pickle, test-set
figures and videos.

Counterpart of hashnerf_tpu/utils/io.py without its plotting and video
libraries:
- figures: `{i:03d}.png`, the rgb and the depth side by side at native
  pixels, the depth through matplotlib's `plasma` map (vmin 0, vmax 1), a
  256-entry table carried here (matplotlib's own figure margins are not
  reproduced);
- videos: an mp4 by piping rgb24 frames to an `ffmpeg` executable when one
  is on PATH, else an animated GIF of the same name (the JAX package's own
  fallback when imageio has no ffmpeg), written here: a fixed 3-3-2 colour
  table and LZW codes that never grow past 9 bits (a clear code every 250
  pixels), so the stream is packed with numpy.
"""
from __future__ import annotations

import os
import pickle
import shutil
import struct
import subprocess
from typing import Optional, Sequence

import numpy as np

from hashnerf_torch.utils.metrics import to8b
from hashnerf_torch.utils.png import write_png

# matplotlib's "plasma" colormap as 8-bit RGB, cmap(i / 255, bytes=True)
PLASMA = np.frombuffer(bytes.fromhex(
    "0c078610078713068915068a18068b1b068c1d068d1f058e21058f2305902505912705922905932b05942d04942f0495"
    "3104963304973404983604983804993a049a3b039a3d039b3f039c40039c42039d44039e45039e47029f49029f4a02a0"
    "4c02a14e02a14f02a25101a25201a35401a35601a35701a45901a45a00a55c00a55e00a55f00a66100a66200a66400a7"
    "6500a76700a76800a76a00a76c00a86d00a86f00a87000a87200a87300a87500a87601a87801a87901a87b02a87c02a7"
    "7e03a77f03a78104a78204a78405a68506a68607a68807a58908a58b09a48c0aa48e0ca48f0da3900ea3920fa29310a1"
    "9511a19612a09713a099149f9a159e9b179e9d189d9e199c9f1a9ba01b9ba21c9aa31d99a41e98a51f97a72197a82296"
    "a92395aa2494ac2593ad2692ae2791af2890b02a8fb12b8fb22c8eb42d8db52e8cb62f8bb7308ab83289b93388ba3487"
    "bb3586bc3685bd3784be3883bf3982c03b81c13c80c23d80c33e7fc43f7ec5407dc6417cc7427bc8447ac94579ca4678"
    "cb4777cc4876cd4975ce4a75cf4b74d04d73d14e72d14f71d25070d3516fd4526ed5536dd6556dd7566cd7576bd8586a"
    "d95969da5a68db5b67dc5d66dc5e66dd5f65de6064df6163df6262e06461e16560e26660e3675fe3685ee46a5de56b5c"
    "e56c5be66d5ae76e5ae87059e87158e97257ea7356ea7455eb7654ec7754ec7853ed7952ed7b51ee7c50ef7d4fef7e4e"
    "f0804df0814df1824cf2844bf2854af38649f38748f48947f48a47f58b46f58d45f68e44f68f43f69142f79241f79341"
    "f89540f8963ff8983ef9993df99a3cfa9c3bfa9d3afa9f3afaa039fba238fba337fba436fca635fca735fca934fcaa33"
    "fcac32fcad31fdaf31fdb030fdb22ffdb32efdb52dfdb62dfdb82cfdb92bfdbb2bfdbc2afdbe29fdc029fdc128fdc328"
    "fdc427fdc626fcc726fcc926fccb25fccc25fcce25fbd024fbd124fbd324fad524fad624fad824f9d924f9db24f8dd24"
    "f8df24f7e024f7e225f6e425f6e525f5e726f5e926f4ea26f3ec26f3ee26f2f026f2f126f1f326f0f525f0f623eff821"
), np.uint8).reshape(256, 3)


def dump_args(savepath: str, args_dict: dict, config_path: Optional[str] = None) -> None:
    os.makedirs(savepath, exist_ok=True)
    with open(os.path.join(savepath, "args.txt"), "w") as f:
        for k in sorted(args_dict):
            f.write("{} = {}\n".format(k, args_dict[k]))
    if config_path is not None and os.path.exists(config_path):
        shutil.copyfile(config_path, os.path.join(savepath, "config.txt"))


def save_loss_history(savepath: str, losses, psnrs, times) -> None:
    with open(os.path.join(savepath, "loss_vs_time.pkl"), "wb") as fp:
        pickle.dump({"losses": losses, "psnr": psnrs, "time": times}, fp)


def save_psnr_pickle(savedir: str, psnrs: Sequence[float]) -> None:
    os.makedirs(savedir, exist_ok=True)
    avg = sum(psnrs) / len(psnrs)
    with open(os.path.join(savedir, "test_psnrs_avg{:0.2f}.pkl".format(avg)), "wb") as fp:
        pickle.dump(list(psnrs), fp)


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8 through PLASMA, as matplotlib maps a
    value with vmin 0 and vmax 1: entry floor(256 d), below 0 the first,
    from 1 on the last; NaN black."""
    d = np.asarray(depth, np.float64) * 256.0
    idx = np.clip(np.nan_to_num(d, nan=0.0), 0, 255).astype(np.int64)
    out = PLASMA[idx]
    out[np.isnan(d)] = 0
    return out


def save_render_figures(savedir: str, rgbs: np.ndarray, depths: np.ndarray) -> None:
    """One `{i:03d}.png` a pose: rgb | plasma depth, (H, 2W, 3)."""
    os.makedirs(savedir, exist_ok=True)
    for i in range(rgbs.shape[0]):
        fig = np.concatenate([to8b(rgbs[i]), colorize_depth(depths[i])], axis=1)
        write_png(os.path.join(savedir, "{:03d}.png".format(i)), fig)


def _rgb_frames(frames: np.ndarray) -> np.ndarray:
    """(N, H, W[, 3]) floats in [0, 1] -> (N, H, W, 3) uint8."""
    u8 = to8b(frames)
    return np.repeat(u8[..., None], 3, axis=-1) if u8.ndim == 3 else u8


# the GIF colour table: 8 red x 8 green x 4 blue levels
_GIF_LEVELS = (7, 7, 3)
GIF_PALETTE = np.stack(np.meshgrid(
    *[np.round(np.arange(n + 1) * 255.0 / n) for n in _GIF_LEVELS], indexing="ij"),
    -1).reshape(256, 3).astype(np.uint8)
_GIF_CLEAR, _GIF_END, _GIF_RUN = 256, 257, 250


def gif_indices(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 -> (...) GIF_PALETTE indices of the nearest levels."""
    q = [(rgb[..., c].astype(np.int32) * n + 127) // 255 for c, n in enumerate(_GIF_LEVELS)]
    return (q[0] * 32 + q[1] * 4 + q[2]).astype(np.int32)


def _lzw_9bit(idx: np.ndarray) -> bytes:
    """A GIF LZW stream (minimum code size 8) of the indices, as literal
    codes with a clear code before every run of _GIF_RUN: the decoder's
    table never reaches 512 entries, so every code is 9 bits wide."""
    n = idx.size
    nfull = n // _GIF_RUN
    parts = [np.concatenate([np.full((nfull, 1), _GIF_CLEAR), idx[:nfull * _GIF_RUN]
                             .reshape(nfull, _GIF_RUN)], 1).ravel()]
    if n % _GIF_RUN:
        parts.append(np.concatenate([[_GIF_CLEAR], idx[nfull * _GIF_RUN:]]))
    parts.append(np.array([_GIF_END]))
    codes = np.concatenate(parts).astype(np.int32)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.ravel(), bitorder="little")
    nb = data.size // 255
    blocks = np.concatenate([np.full((nb, 1), 255, np.uint8), data[:nb * 255].reshape(nb, 255)], 1)
    tail = data[nb * 255:]
    out = blocks.tobytes()
    if tail.size:
        out += bytes([tail.size]) + tail.tobytes()
    return out + b"\x00"


def write_gif(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """An animated GIF of (N, H, W, 3) uint8 frames, looping forever."""
    N, H, W = frames.shape[:3]
    delay = max(1, int(round(100.0 / fps)))
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0), GIF_PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        out += [b"\x21\xf9\x04" + struct.pack("<BHBB", 0, delay, 0, 0),
                b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0), b"\x08",
                _lzw_9bit(gif_indices(f).ravel())]
    out.append(b"\x3b")
    with open(path, "wb") as fp:
        fp.write(b"".join(out))


def save_video(path: str, frames: np.ndarray, fps: int = 30) -> str:
    """An mp4 of the frames through the `ffmpeg` on PATH, else an animated
    GIF beside it (`path` with .gif, at most 24 fps). Returns the path
    written; a failing ffmpeg raises."""
    rgb = _rgb_frames(frames)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        gif_path = os.path.splitext(path)[0] + ".gif"
        write_gif(gif_path, rgb, fps=min(fps, 24))
        return gif_path
    N, H, W = rgb.shape[:3]
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
           "-s", f"{W}x{H}", "-r", str(fps), "-i", "-",
           "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2", "-pix_fmt", "yuv420p", path]
    r = subprocess.run(cmd, input=rgb.tobytes(), capture_output=True)
    if r.returncode != 0:
        raise RuntimeError(f"ffmpeg failed ({r.returncode}) writing {path}: "
                           f"{r.stderr.decode(errors='replace')[-2000:]}")
    return path
