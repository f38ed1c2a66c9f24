"""The standard-library PNG codec (flatmatch/io/png.py) against Pillow."""
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from flatmatch.io import png
from tests.conftest import FIXTURES


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filtered(rows, bpp, ftype):
    """Apply PNG filter `ftype` (one for every row, or one per row) to raw
    scanlines (list of bytes)."""
    out = b""
    prev = bytes(len(rows[0]))
    ftypes = [ftype] * len(rows) if isinstance(ftype, int) else ftype
    for row, ftype in zip(rows, ftypes):
        f = bytearray(len(row))
        for i, x in enumerate(row):
            left = row[i - bpp] if i >= bpp else 0
            up = prev[i]
            ul = prev[i - bpp] if i >= bpp else 0
            pred = (0, left, up, (left + up) >> 1, _paeth(left, up, ul))[ftype]
            f[i] = (x - pred) & 0xFF
        out += bytes([ftype]) + bytes(f)
        prev = row
    return out


def _make_png(path, rows, width, depth, ctype, bpp, ftype, plte=None,
              trns=None):
    data = (png.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, len(rows),
                                          depth, ctype, 0, 0, 0)))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(_filtered(rows, bpp, ftype)))
    data += _chunk(b"IEND", b"")
    path.write_bytes(data)


def _pillow_rgba(path):
    return np.asarray(Image.open(path).convert("RGBA"))


RNG = np.random.default_rng(0)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_filter_types_match_pillow(tmp_path, ftype):
    img = RNG.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    rows = [img[y].tobytes() for y in range(9)]
    p = tmp_path / f"f{ftype}.png"
    _make_png(p, rows, 13, 8, 2, 3, ftype)
    got = png.read_png(p)
    np.testing.assert_array_equal(got, _pillow_rgba(p))
    np.testing.assert_array_equal(got[..., :3], img)


@pytest.mark.parametrize("ctype,ch", [(0, 1), (2, 3), (6, 4)])
def test_mixed_filter_rows_match_pillow(tmp_path, ctype, ch):
    """Runs of Average/Paeth rows (decoded along anti-diagonals) between
    None/Sub/Up rows, wider than tall and taller than wide."""
    for h, w in ((11, 37), (40, 6)):
        img = RNG.integers(0, 256, (h, w, ch), dtype=np.uint8)
        rows = [img[y].tobytes() for y in range(h)]
        ftypes = [int(t) for t in RNG.choice([0, 1, 2, 3, 4, 4, 3, 4], h)]
        ftypes[:3] = [4, 3, 4]  # a run at the top edge
        p = tmp_path / f"m{h}.png"
        _make_png(p, rows, w, 8, ctype, ch, ftypes)
        got = png.read_png(p)
        np.testing.assert_array_equal(got, _pillow_rgba(p))
        np.testing.assert_array_equal(got[..., :ch], img)


@pytest.mark.parametrize(
    "kind", ["gray", "gray_alpha", "rgba", "palette8", "palette4_trns",
             "gray1", "gray_trns", "rgb_trns"],
)
def test_color_types_match_pillow(tmp_path, kind):
    h, w = 7, 11
    p = tmp_path / f"{kind}.png"
    plte = trns = None
    if kind == "gray":
        a = RNG.integers(0, 256, (h, w), dtype=np.uint8)
        rows, depth, ctype, bpp = [a[y].tobytes() for y in range(h)], 8, 0, 1
    elif kind == "gray_trns":
        a = RNG.integers(0, 4, (h, w), dtype=np.uint8) * 60
        rows, depth, ctype, bpp = [a[y].tobytes() for y in range(h)], 8, 0, 1
        trns = struct.pack(">H", 120)
    elif kind == "gray_alpha":
        a = RNG.integers(0, 256, (h, w, 2), dtype=np.uint8)
        rows, depth, ctype, bpp = [a[y].tobytes() for y in range(h)], 8, 4, 2
    elif kind == "rgba":
        a = RNG.integers(0, 256, (h, w, 4), dtype=np.uint8)
        rows, depth, ctype, bpp = [a[y].tobytes() for y in range(h)], 8, 6, 4
    elif kind == "rgb_trns":
        a = RNG.integers(0, 2, (h, w, 3), dtype=np.uint8) * 255
        rows, depth, ctype, bpp = [a[y].tobytes() for y in range(h)], 8, 2, 3
        trns = struct.pack(">HHH", 255, 0, 255)
    elif kind == "palette8":
        a = RNG.integers(0, 40, (h, w), dtype=np.uint8)
        plte = RNG.integers(0, 256, 40 * 3, dtype=np.uint8).tobytes()
        rows, depth, ctype, bpp = [a[y].tobytes() for y in range(h)], 8, 3, 1
    elif kind == "palette4_trns":
        a = RNG.integers(0, 16, (h, w), dtype=np.uint8)
        plte = RNG.integers(0, 256, 16 * 3, dtype=np.uint8).tobytes()
        trns = bytes(range(0, 160, 20))  # alpha for the first 8 entries
        packed = np.zeros((h, (w + 1) // 2), np.uint8)
        for x in range(w):
            packed[:, x // 2] |= a[:, x] << (4 * (1 - x % 2))
        rows, depth, ctype, bpp = [packed[y].tobytes() for y in range(h)], \
            4, 3, 1
    else:  # gray1
        a = RNG.integers(0, 2, (h, w), dtype=np.uint8)
        packed = np.packbits(a, axis=1)
        rows, depth, ctype, bpp = [packed[y].tobytes() for y in range(h)], \
            1, 0, 1
    _make_png(p, rows, w, depth, ctype, bpp, 4, plte, trns)
    np.testing.assert_array_equal(png.read_png(p), _pillow_rgba(p))


@pytest.mark.parametrize("name", ["tiny", "mini"])
def test_layout_fixtures_decode_like_pillow(name):
    p = FIXTURES / f"{name}.png"
    np.testing.assert_array_equal(png.read_png(p), _pillow_rgba(p))


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_encode_roundtrip_through_pillow(tmp_path, channels):
    shape = (6, 5) if channels == 0 else (6, 5, channels)
    img = RNG.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "out.png"
    png.write_png(p, img)
    back = np.asarray(Image.open(io.BytesIO(p.read_bytes())))
    np.testing.assert_array_equal(back, img)
    assert png.read_png(p).shape == (6, 5, 4)


@pytest.mark.parametrize("hdr", ["interlaced", "16bit", "not_png"])
def test_unsupported_pngs_are_refused(tmp_path, hdr):
    p = tmp_path / "bad.png"
    if hdr == "not_png":
        p.write_bytes(b"GIF89a" + bytes(20))
    else:
        depth, interlace = (16, 0) if hdr == "16bit" else (8, 1)
        p.write_bytes(
            png.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, depth, 2, 0, 0,
                                          interlace))
            + _chunk(b"IDAT", zlib.compress(bytes(2 * 13)))
            + _chunk(b"IEND", b"")
        )
    with pytest.raises(ValueError):
        png.read_png(p)
