"""Device-resident scene: rectangle struct-of-arrays + emitter table.

The reference ships an array-of-structs Rectangle buffer to the GPU
(/root/reference/global_illumination_cl.c:290-295). The design here is a
struct-of-arrays pytree, padded to a lane multiple, with per-rect derived
quantities (unit spans, lengths, plane offsets) precomputed once on the host
so the hot intersection loop is pure elementwise/matmul work. The scene is
tiny (O(100) rects) and is replicated on every chip; photons are the sharded
axis (SURVEY.md §7).

Padding entries have n == 0, so `denom >= 0` back-face culling rejects them
(rectangle.c:70-72) and they can never be hit.
"""
from __future__ import annotations

from typing import List, NamedTuple

import jax.numpy as jnp
import numpy as np

from ..scene.geometry import Scene
from ..scene.rectangle import Rect, area_f32, length_f32, num_tiles

f32 = np.float32


class RectsDev(NamedTuple):
    """Packed rectangle set on device. Shapes: [N,3] vectors, [N] scalars."""

    pos: jnp.ndarray
    wvec: jnp.ndarray
    hvec: jnp.ndarray
    n: jnp.ndarray
    w_unit: jnp.ndarray   # wvec / |wvec|
    h_unit: jnp.ndarray
    wlen: jnp.ndarray
    hlen: jnp.ndarray
    n_off: jnp.ndarray    # dot(n, pos): plane offset for intersection
    base: jnp.ndarray     # int32 texel arena base index
    wtiles: jnp.ndarray   # int32
    htiles: jnp.ndarray   # int32


class EmittersDev(NamedTuple):
    """Photon emitters (windows then lights), concatenated.

    Engines drive emitters with a host loop in the reference dispatch order
    (global_illumination_cl.c:304-308), tracing each budget as fixed-shape
    device batches with a masked tail. `counts` stays a HOST int64 array:
    production budgets exceed int32 (1e8/m^2 x tens of m^2) and jnp would
    silently wrap them.
    """

    pos: jnp.ndarray       # [E,3]
    wvec: jnp.ndarray      # [E,3]
    hvec: jnp.ndarray      # [E,3]
    n: jnp.ndarray         # [E,3]
    color: jnp.ndarray     # [E,3] initial photon flux color
    is_window: jnp.ndarray  # [E] bool: sky sampler vs cosine sampler
    area: jnp.ndarray      # [E]
    counts: np.ndarray     # [E] int64 photon budget per emitter (host)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def pack_rects(rects: List[Rect], pad_to: int = 128) -> RectsDev:
    """Pack host rectangles into the padded device SoA."""
    count = len(rects)
    n_pad = max(((count + pad_to - 1) // pad_to) * pad_to, pad_to)
    pos = np.array([r.pos for r in rects], f32).reshape(count, 3)
    wvec = np.array([r.width for r in rects], f32).reshape(count, 3)
    hvec = np.array([r.height for r in rects], f32).reshape(count, 3)
    nrm = np.array([r.n for r in rects], f32).reshape(count, 3)
    wlen = np.array([length_f32(r.width) for r in rects], f32)
    hlen = np.array([length_f32(r.height) for r in rects], f32)
    w_unit = wvec / wlen[:, None]
    h_unit = hvec / hlen[:, None]
    n_off = np.sum(nrm * pos, axis=-1, dtype=f32)
    base = np.array([r.base for r in rects], np.int32)
    wt = np.array([r.wtiles for r in rects], np.int32)
    ht = np.array([r.htiles for r in rects], np.int32)
    return RectsDev(
        pos=jnp.asarray(_pad_rows(pos, n_pad)),
        wvec=jnp.asarray(_pad_rows(wvec, n_pad)),
        hvec=jnp.asarray(_pad_rows(hvec, n_pad)),
        n=jnp.asarray(_pad_rows(nrm, n_pad)),
        w_unit=jnp.asarray(_pad_rows(w_unit, n_pad)),
        h_unit=jnp.asarray(_pad_rows(h_unit, n_pad)),
        wlen=jnp.asarray(_pad_rows(wlen, n_pad)),
        hlen=jnp.asarray(_pad_rows(hlen, n_pad)),
        n_off=jnp.asarray(_pad_rows(n_off, n_pad)),
        base=jnp.asarray(_pad_rows(base, n_pad)),
        wtiles=jnp.asarray(np.maximum(_pad_rows(wt, n_pad), 1)),
        htiles=jnp.asarray(np.maximum(_pad_rows(ht, n_pad), 1)),
    )


def pack_emitters(
    scene: Scene,
    samples_per_area: float,
    window_color,
    light_color,
) -> EmittersDev:
    """Emitter table with per-emitter photon budgets.

    Budgets follow the native engine: numSamples = (uint64)(samplesPerArea
    * area), i.e. truncation of the float product (photonmap.c:417-418).
    Windows come first, then lights, matching the reference dispatch order
    (global_illumination_cl.c:304-308).
    """
    ems = list(scene.windows) + list(scene.lights)
    n_win = len(scene.windows)
    if not ems:
        raise ValueError("scene has no emitters (no windows and no lights)")
    pos = np.array([r.pos for r in ems], f32)
    wvec = np.array([r.width for r in ems], f32)
    hvec = np.array([r.height for r in ems], f32)
    nrm = np.array([r.n for r in ems], f32)
    area = np.array([area_f32(r) for r in ems], f32)
    counts = (np.float32(samples_per_area) * area).astype(np.int64)
    color = np.array(
        [window_color] * n_win + [light_color] * (len(ems) - n_win), f32
    )
    is_window = np.arange(len(ems)) < n_win
    return EmittersDev(
        pos=jnp.asarray(pos),
        wvec=jnp.asarray(wvec),
        hvec=jnp.asarray(hvec),
        n=jnp.asarray(nrm),
        color=jnp.asarray(color),
        is_window=jnp.asarray(is_window),
        area=jnp.asarray(area),
        counts=counts,
    )


def exposure_scale(scene: Scene, samples_per_area: float, exposure: float) -> np.ndarray:
    """Per-texel photon-count exposure normalization vector (main.c:68-79).

    texel *= exposure * numTiles(wall) / (area(wall) * samplesPerArea),
    applied to level-0 texels of every wall; mipmap slots get scale 0 (they
    are never written by the photon engines and must stay zero).
    """
    scale = np.zeros(scene.num_texels, f32)
    for r in scene.walls:
        tiles_per_sample = f32(
            num_tiles(r) / np.float64(area_f32(r) * samples_per_area)
        )
        scale[r.base : r.base + num_tiles(r)] = f32(
            np.float64(exposure) * tiles_per_sample
        )
    return scale
