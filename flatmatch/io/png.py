"""PNG codec on the standard library (zlib + struct).

The renderer reads layout PNGs and writes lightmap tiles; this keeps both off
any imaging package. Reading covers 8-bit gray, gray+alpha, RGB and RGBA,
palette images at 1, 2, 4 or 8 bits, and all five scanline filter types;
every image is returned as RGBA the way an imaging library converts it (gray
replicated, palette looked up, tRNS transparency applied, alpha 255
elsewhere). Interlaced and 16-bit images are refused. Writing emits 8-bit
gray, RGB or RGBA with filter type 0.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per color type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_run(f: np.ndarray, ftype: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo Average (3) and Paeth (4) on a run of rows f [n, stride] below
    the decoded row `prev`.

    Each byte depends on its left, upper and upper-left neighbours, so the
    run is decoded along anti-diagonals of pixels, all rows at once: pixel
    (y, x) sits at s[y + 1, y + x + 2] of a skewed buffer whose row 0 holds
    `prev` and whose never-written cells are the zero neighbours outside
    the image."""
    n, stride = f.shape
    w = stride // bpp
    fs = np.zeros((n, w + n, bpp), np.int16)
    ys = np.arange(n)[:, None]
    xs = np.arange(w)[None, :]
    fs[ys, ys + xs] = f.reshape(n, w, bpp)
    s = np.zeros((n + 1, w + n + 2, bpp), np.int16)
    s[0, 1:w + 1] = prev.reshape(w, bpp)
    paeth = (ftype == 4)[:, None]
    for t in range(n + w - 1):
        lo, hi = max(0, t - w + 1), min(n - 1, t) + 1
        a = s[lo + 1:hi + 1, t + 1]
        b = s[lo:hi, t + 1]
        c = s[lo:hi, t]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where(
            paeth[lo:hi],
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)),
            (a + b) >> 1,
        )
        s[lo + 1:hi + 1, t + 2] = (fs[lo:hi, t] + pred) & 0xFF
    return s[1 + ys, ys + xs + 2].reshape(n, stride).astype(np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: [height, stride] uint8."""
    lines = np.frombuffer(raw, np.uint8, height * (stride + 1))
    lines = lines.reshape(height, stride + 1)
    ftype, f = lines[:, 0], lines[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {ftype.max()} is invalid")
    out = np.zeros((height + 1, stride), np.uint8)  # out[0]: row above
    y = 0
    while y < height:
        prev = out[y]
        if ftype[y] >= 3:  # Average / Paeth: decode the whole run
            end = y + 1
            while end < height and ftype[end] >= 3:
                end += 1
            out[y + 1:end + 1] = _unfilter_run(f[y:end], ftype[y:end], prev,
                                               bpp)
            y = end
            continue
        line = f[y]
        if ftype[y] == 0:
            cur = line
        elif ftype[y] == 1:  # Sub: running sum per byte lane, mod 256
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            cur = (lanes.cumsum(axis=0).reshape(-1) & 0xFF).astype(np.uint8)
        else:  # Up
            cur = line + prev
        out[y + 1] = cur
        y += 1
    return out[1:]


def read_png(path) -> np.ndarray:
    """Decode a PNG file to uint8 RGBA [H, W, 4]."""
    with open(path, "rb") as f:
        data = f.read()
    idat = []
    palette = trns = None
    hdr = None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG color type {ctype} is invalid")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit PNGs of color type {ctype} are not "
                         f"supported")
    ch = _CHANNELS[ctype]
    stride = (width * ch * depth + 7) // 8
    rows = _unfilter(
        zlib.decompress(b"".join(idat)), height, stride, max(1, ch * depth // 8)
    )
    if depth < 8:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        px = vals.reshape(height, stride * per)[:, :width]
        if ctype == 0:  # low-depth gray scales to the 8-bit range
            px = px * (255 // ((1 << depth) - 1))
        px = px.astype(np.uint8)[..., None]
    else:
        px = rows.reshape(height, width, ch)

    rgba = np.empty((height, width, 4), np.uint8)
    rgba[..., 3] = 255
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = px[..., 0]
        rgba[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)
            rgba[..., 3] = alpha[idx]
    elif ctype in (0, 4):
        rgba[..., :3] = px[..., :1]
        if ctype == 4:
            rgba[..., 3] = px[..., 1]
        elif trns is not None:
            (key,) = struct.unpack(">H", trns[:2])
            rgba[..., 3] = np.where(
                px[..., 0] == (key & 0xFF) if depth == 8 else
                px[..., 0] == key * (255 // ((1 << depth) - 1)), 0, 255
            )
    else:
        rgba[..., :3] = px[..., :3]
        if ctype == 6:
            rgba[..., 3] = px[..., 3]
        elif trns is not None:
            key = np.asarray(struct.unpack(">HHH", trns[:6])) & 0xFF
            rgba[..., 3] = np.where(
                np.all(px[..., :3] == key, axis=-1), 0, 255
            )
    return rgba


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray) -> bytes:
    """Encode uint8 gray [H, W], RGB [H, W, 3] or RGBA [H, W, 4]."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ch = img.shape[2]
        ctype = 2 if ch == 3 else 6
    else:
        raise ValueError(f"cannot encode an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * ch), np.uint8)  # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, w * ch)
    return (
        SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
