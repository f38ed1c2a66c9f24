"""Native C++ raster kernels (ctypes bindings).

Compiles flatmatch/native/raster.cc with g++ on first use into a
library named after the source's hash (untracked, listed in .gitignore), so
a stale build is never loaded, and exposes the scene compiler's hot
host-side loops. Falls back silently if no compiler is available — callers
must treat `available()` as the gate and keep the NumPy/SciPy
implementations (flatmatch/scene/image.py) as the portable path.
"""
from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "raster.cc"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _HERE / f"libflatmatch_raster-{digest}.so"


def _build_and_load():
    lib_path = library_path()
    if not lib_path.exists():
        with tempfile.TemporaryDirectory() as td:
            tmp = pathlib.Path(td) / lib_path.name
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True,
                capture_output=True,
            )
            tmp.replace(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    c = ctypes
    lib.fm_distance_transform.argtypes = [i8p, c.c_int32, c.c_int32, i32p]
    lib.fm_distance_transform.restype = c.c_int32
    lib.fm_flood_fill.argtypes = [
        u32p, c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_uint32, c.c_uint32
    ]
    lib.fm_dilate.argtypes = [i8p, c.c_int32, c.c_int32, c.c_int32, i8p]
    lib.fm_rle.argtypes = [i8p, c.c_int64, c.c_uint8, i64p]
    lib.fm_rle.restype = c.c_int64
    lib.fm_decompose.argtypes = [u32p, c.c_int32, c.c_int32, c.c_uint32, i64p]
    lib.fm_decompose.restype = c.c_int64
    return lib


def _lib():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is None and not _TRIED:
            _TRIED = True
            try:
                _LIB = _build_and_load()
            except Exception:
                _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def distance_transform(mask: np.ndarray):
    """Native twin of scene.image.distance_transform (image.c:88-142)."""
    lib = _lib()
    seeds = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = seeds.shape
    out = np.empty((h, w), np.int32)
    maxd = lib.fm_distance_transform(seeds, h, w, out)
    return out.astype(np.int64), int(maxd)


def flood_fill(img: np.ndarray, x: int, y: int, value: int, background: int):
    """Native twin of scene.image.flood_fill (image.c:144-179), in place."""
    lib = _lib()
    assert img.dtype == np.uint32 and img.flags.c_contiguous
    h, w = img.shape
    lib.fm_flood_fill(img, h, w, int(x), int(y), value & 0xFFFFFFFF,
                      background & 0xFFFFFFFF)


def dilate_mask(mask: np.ndarray, radius: int) -> np.ndarray:
    """Native twin of scene.image.dilate_mask (parseLayout.c:571-594)."""
    lib = _lib()
    src = np.ascontiguousarray(mask, np.uint8)
    h, w = src.shape
    out = np.empty((h, w), np.uint8)
    lib.fm_dilate(src, h, w, int(radius), out)
    return out.astype(bool)


def rle(mask: np.ndarray, first_value: bool) -> np.ndarray:
    """Row-major run-length encode; first run counts `first_value` entries
    (parseLayout.c:538-569)."""
    lib = _lib()
    flat = np.ascontiguousarray(mask.reshape(-1), np.uint8)
    runs = np.empty(flat.size + 1, np.int64)
    n = lib.fm_rle(flat, flat.size, 1 if first_value else 0, runs)
    return runs[:n].copy()


def decompose(img: np.ndarray, invalid: int) -> np.ndarray:
    """Greedy rectangle decomposition (parseLayout.c:425-491). Destructive on
    `img`; returns [K,5] int64 rows (x0, y0, x1, y1, color)."""
    lib = _lib()
    assert img.dtype == np.uint32 and img.flags.c_contiguous
    h, w = img.shape
    rects = np.empty((h * w, 5), np.int64)
    n = lib.fm_decompose(img, h, w, invalid & 0xFFFFFFFF, rects.reshape(-1))
    return rects[:n].copy()
