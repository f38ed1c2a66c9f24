"""Point -> lightmap-texel addressing on device.

Mirrors getTileIdAt (/root/reference/rectangle.c:205-230, photonmap.cl:95-120):
project the hit point onto the rect's span axes, scale by the tile grid, and
truncate toward zero with clamping. The flat texel arena with per-rect base
indices (parseLayout.c:512-517) is kept verbatim — flat addressing suits the
device (SURVEY.md §7).
"""
from __future__ import annotations

import jax.numpy as jnp

from .device_scene import RectsDev
from .linalg import dot3


def texel_index(rects: RectsDev, hit, p):
    """Arena texel index for hit points p [B,3] on rects `hit` [B] int32."""
    pdir = p - rects.pos[hit]
    dx = dot3(rects.w_unit[hit], pdir)
    dy = dot3(rects.h_unit[hit], pdir)
    wt = rects.wtiles[hit]
    ht = rects.htiles[hit]
    # (int) cast truncates toward zero (rectangle.c:220-221); so does
    # astype(int32) on floats in XLA.
    tx = jnp.clip((dx * wt.astype(dx.dtype) / rects.wlen[hit]).astype(jnp.int32), 0, wt - 1)
    ty = jnp.clip((dy * ht.astype(dy.dtype) / rects.hlen[hit]).astype(jnp.int32), 0, ht - 1)
    return rects.base[hit] + ty * wt + tx
