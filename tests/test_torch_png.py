"""The port's PNG reader and writer (hashnerf_torch/utils/png.py) against
imageio: Pillow-written gray, gray+alpha, RGB and RGBA files, files whose
rows use each of the five filters, the writer's files read back by
imageio, and the formats the reader refuses."""
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from hashnerf_torch.utils.png import read_png, read_pngs, write_png

CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _image(rng, H, W, C):
    """Smooth ramps plus noise and a disc, so that Pillow's filter choice
    varies from row to row."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    chans = [(x * 1.7 + y * 0.4) % 256, 128 + 100 * np.sin(x / 7 + y / 11), (y * 2.3) % 256,
             np.where((x - W / 2) ** 2 + (y - H / 2) ** 2 < (H / 3) ** 2, 255, 30)]
    img = np.stack(chans[:C], -1) + rng.integers(0, 4, (H, W, C))
    return img.clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_reader_matches_imageio_on_pillow_files(tmp_path, mode):
    rng = np.random.default_rng(0)
    img = _image(rng, 61, 77, CHANNELS[mode])
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img[..., 0] if mode == "L" else img).save(path)
    got, want = read_png(path), imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG whose row r uses filter filters[r] (0-4)."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int32)
    up = np.vstack([np.zeros((1, W * C), np.int32), x[:-1]])
    left = np.hstack([np.zeros((H, C), np.int32), x[:, :-C]])
    upleft = np.hstack([np.zeros((H, C), np.int32), up[:, :-C]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = [np.zeros_like(x), left, up, (left + up) // 2, paeth]
    rows = []
    for r, f in enumerate(filters):
        rows.append(bytes([f]) + ((x[r] - preds[f][r]) % 256).astype(np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_reader_undoes_every_filter(tmp_path, C):
    rng = np.random.default_rng(C)
    H, W = 40, 23
    img = rng.integers(0, 256, (H, W, C)).astype(np.uint8)
    img[::3] = _image(rng, H, W, C)[::3]  # some smooth rows between the noisy ones
    filters = [int(f) for f in rng.permutation(np.arange(H) % 5)]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(img, filters))
    want = imageio.imread(path)
    np.testing.assert_array_equal(want.reshape(H, W, C), img)  # the crafted file is right
    np.testing.assert_array_equal(read_png(path), want)


def test_batched_decode_keeps_each_file(tmp_path):
    """Files of two sizes, each decoded as imageio decodes it, in order."""
    rng = np.random.default_rng(3)
    paths, want = [], []
    for i, (H, W) in enumerate([(20, 30), (31, 17), (20, 30), (20, 30), (31, 17)]):
        img = _image(rng, H, W, 4)
        img = np.roll(img, 3 * i, axis=1)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(paths[-1])
        want.append(imageio.imread(paths[-1]))
    for got, w in zip(read_pngs(paths), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("C", [1, 3, 4])
def test_writer_is_read_back_by_imageio(tmp_path, C):
    img = _image(np.random.default_rng(4), 33, 45, C)
    img = img[..., 0] if C == 1 else img
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(read_png(path), img)


def _ihdr_png(depth: int, color: int, interlace: int) -> bytes:
    """A PNG with the given header and zero-filled rows of a 4 x 4 image."""
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    row = 1 + 4 * chans * depth // 8
    chunk = lambda t, b: struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))
    body = [chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, color, 0, 0, interlace))]
    if color == 3:
        body.append(chunk(b"PLTE", bytes(3 * 256)))
    return (b"\x89PNG\r\n\x1a\n" + b"".join(body)
            + chunk(b"IDAT", zlib.compress(bytes(4 * row))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind,what", [
    ("4-bit", "4-bit"),
    ("interlaced", "interlaced"),
    ("palette", "palette"),
    ("pillow-1-bit", "1-bit"),
    ("bad-crc", "CRC"),
    ("truncated", "truncated"),
])
def test_reader_refuses_what_it_does_not_read(tmp_path, kind, what):
    """Bit depths other than 8 and 16 (16 is read since st3d's depth
    panoramas: test_reader_reads_16_bit), interlacing, palettes, bad CRCs
    and truncated files raise, naming what they met."""
    path = str(tmp_path / "x.png")
    write_png(path, np.zeros((4, 4, 3), np.uint8))
    with open(path, "rb") as f:
        good = f.read()
    if kind == "pillow-1-bit":
        Image.fromarray(np.arange(64).reshape(8, 8) % 3 == 0).save(path)
    else:
        data = {"4-bit": _ihdr_png(4, 0, 0), "interlaced": _ihdr_png(8, 6, 1),
                "palette": _ihdr_png(8, 3, 0), "bad-crc": good[:-5] + b"\x00" * 5,
                "truncated": good[:45]}[kind]
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match=what):
        read_png(path)


@pytest.mark.parametrize("kind", ["pillow-gray", "zeros-rgb", "port-rgba"])
def test_reader_reads_16_bit(tmp_path, kind):
    """16-bit samples (big-endian) come back as uint16: PIL's 16-bit gray
    with its own filters, a hand-made RGB file, the port's own RGBA file."""
    path = str(tmp_path / "x.png")
    if kind == "pillow-gray":
        want = ((np.arange(64 * 48).reshape(48, 64) * 7919) % 65536).astype(np.uint16)
        Image.fromarray(want).save(path)
    elif kind == "zeros-rgb":
        want = np.zeros((4, 4, 3), np.uint16)
        with open(path, "wb") as f:
            f.write(_ihdr_png(16, 2, 0))
    else:
        want = np.random.default_rng(6).integers(0, 65536, (9, 13, 4)).astype(np.uint16)
        write_png(path, want)
    got = read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
