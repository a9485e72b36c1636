"""PNG read and write with the standard library's zlib and numpy.

The port's stand-in for imageio's PNG plugin (the JAX package reads frames
with `imageio.imread` in hashnerf_tpu/data/blender.py and writes them with
`imageio.imwrite` in hashnerf_tpu/tools/make_blender_dataset.py).

Read: 8-bit gray, gray + alpha, RGB and RGBA, not interlaced, any of the
five row filters. A pixel's filter can use its left, upper and upper-left
neighbours (Average and Paeth cannot be undone with a cumsum), so the
filters are undone as a wavefront: all pixels on one anti-diagonal
r + c = d depend only on diagonals d - 1 and d - 2, and are decoded at once.
The images are sheared first so that each diagonal is a contiguous slice;
images of one size and pixel format are decoded together. Anything else
(other bit depths, palettes, interlacing, a transparency chunk, a bad CRC)
raises ValueError naming what it met.

Write: uint8 (H, W) gray, (H, W, 2), (H, W, 3) or (H, W, 4), filter 0.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
_COLOR_OF_CHANNELS = {1: 0, 2: 4, 3: 2, 4: 6}
# images decoded together by the wavefront, to bound its memory
_BATCH = 16


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: chunk {ctype!r} is truncated")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _parse(path: str) -> Tuple[Tuple[int, int, int], np.ndarray]:
    """((H, W, channels), filtered rows (H, 1 + W * channels) uint8)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            W, H, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            if color not in _CHANNELS:
                raise ValueError(f"{path}: {_COLOR_NAMES.get(color, color)} PNGs are not read "
                                 "(only 8-bit gray, gray+alpha, RGB and RGBA)")
            if depth != 8:
                raise ValueError(f"{path}: {depth}-bit samples are not read (only 8-bit)")
            if interlace != 0:
                raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read")
            if comp != 0 or filt != 0:
                raise ValueError(f"{path}: unknown compression {comp} or filter method {filt}")
            header = (H, W, _CHANNELS[color])
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS":
            raise ValueError(f"{path}: transparency (tRNS) chunks are not read")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    H, W, C = header
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (1 + W * C):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected {H * (1 + W * C)}")
    return header, np.frombuffer(raw, np.uint8).reshape(H, 1 + W * C)


def _unfilter(rows: np.ndarray, W: int, C: int) -> np.ndarray:
    """(N, H, 1 + W*C) filtered rows -> (N, H, W, C) uint8 pixels."""
    N, H = rows.shape[:2]
    ftype = rows[:, :, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    x = rows[:, :, 1:].reshape(N, H, W, C)
    if not (ftype > 0).any():
        return x.copy()
    # sheared layout: pixel (r, c) lives at diagonal r + c + 2, slot r + 1;
    # slots outside the image stay 0, which is what the filters read there
    D = H + W - 1
    r, c = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dg, sl = (r + c + 2).ravel(), (r + 1).ravel()
    xs = np.zeros((N, D + 2, H + 1, C), np.int16)
    xs[:, dg, sl] = x.reshape(N, H * W, C)
    out = np.zeros((N, D + 2, H + 1, C), np.int16)
    ft = ftype.astype(np.int16)[:, :, None]
    for d in range(D):
        r0, r1 = max(0, d - W + 1), min(H - 1, d)
        k = d + 2
        f = ft[:, r0:r1 + 1]
        a = out[:, k - 1, r0 + 1:r1 + 2]  # left (r, c - 1)
        b = out[:, k - 1, r0:r1 + 1]  # up (r - 1, c)
        cc = out[:, k - 2, r0:r1 + 1]  # up-left (r - 1, c - 1)
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(f == 3, (a + b) >> 1,
                                                                 np.where(f == 4, paeth, 0))))
        out[:, k, r0 + 1:r1 + 2] = (xs[:, k, r0 + 1:r1 + 2] + pred) & 0xFF
    return out[:, dg, sl].astype(np.uint8).reshape(N, H, W, C)


def _shape_out(img: np.ndarray) -> np.ndarray:
    return img[..., 0] if img.shape[-1] == 1 else img


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode PNG files into uint8 arrays shaped as imageio gives them:
    (H, W) for gray, else (H, W, channels). Files of one size and pixel
    format are decoded together."""
    parsed = [_parse(p) for p in paths]
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, (hdr, _) in enumerate(parsed):
        groups.setdefault(hdr, []).append(i)
    out: List[np.ndarray] = [None] * len(paths)  # type: ignore[list-item]
    for (H, W, C), idx in groups.items():
        for s in range(0, len(idx), _BATCH):
            part = idx[s:s + _BATCH]
            try:
                pix = _unfilter(np.stack([parsed[i][1] for i in part]), W, C)
            except ValueError as e:
                raise ValueError(f"{[paths[i] for i in part]}: {e}") from None
            for j, i in enumerate(part):
                out[i] = _shape_out(pix[j])
    return out


def read_png(path: str) -> np.ndarray:
    return read_pngs([path])[0]


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Write img as an 8-bit PNG, every row with filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_OF_CHANNELS:
        raise ValueError(f"PNG writer takes (H, W[, 1-4]) images, got {img.shape}")
    H, W, C = img.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_OF_CHANNELS[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
