"""Ambient-occlusion engine (deterministic — the framework's correctness
anchor, SURVEY.md §7 step 7).

Mirrors performAmbientOcclusionNative (/root/reference/photonmap.c:436-491):
for every wall texel, fire all 481 geoSphere-depth-4 directions rotated into
the surface frame, cosine-weight by the direction's z component, count misses
as sky light at distance 10, and write

    texel = sum_k dist_k * fac_k / (sum_k fac_k * 1.5)        (grayscale)

Re-design: the per-texel/per-direction double loop becomes one batched
intersection over [texel-chunk x directions] rays against all wall rects; the
BSP tree is replaced by the brute-force vectorized intersector
(ops/intersect.py). Results are deterministic, so this engine golden-tests
against reference dumps bit-tolerantly.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AoConfig
from ..ops.device_scene import RectsDev
from ..ops.geosphere import geosphere
from ..ops.intersect import intersect_all
from ..scene.geometry import Scene
from ..scene.rectangle import Rect, num_tiles

f32 = np.float32


def _create_base_np(n: np.ndarray):
    """createBase (vector3_cl.c:152-170), host side for one wall normal."""
    c1 = np.array([0, 0, 1], f32)
    if abs(float(np.dot(n, c1))) >= 0.999999:
        c1 = np.array([0, 1, 0], f32)
    c2 = np.cross(c1, n).astype(f32)
    c2 /= np.linalg.norm(c2).astype(f32)
    c1 = np.cross(c2, n).astype(f32)
    c1 /= np.linalg.norm(c1).astype(f32)
    return c1, c2


def wall_directions(n: np.ndarray, level: int) -> np.ndarray:
    """geoSphere directions rotated into the surface frame
    (transformToOrthoNormalBase, photonmap.c:31-48,450-453)."""
    vs = geosphere(level)
    b1, b2 = _create_base_np(n.astype(f32))
    return (
        vs[:, 0:1] * b1[None, :]
        + vs[:, 1:2] * b2[None, :]
        + vs[:, 2:3] * n[None, :].astype(f32)
    ).astype(f32)


def tile_centers(rect: Rect) -> np.ndarray:
    """All level-0 tile centers of a wall [T,3] (getTileCenter,
    rectangle.c:140-154)."""
    wt, ht = rect.wtiles, rect.htiles
    vw = rect.width.astype(f32) / f32(wt)
    vh = rect.height.astype(f32) / f32(ht)
    tx, ty = np.meshgrid(np.arange(wt), np.arange(ht))
    tx = (tx.ravel() + f32(0.5))[:, None]
    ty = (ty.ravel() + f32(0.5))[:, None]
    return (rect.pos[None, :] + vw[None, :] * tx + vh[None, :] * ty).astype(f32)


@functools.partial(jax.jit, static_argnames=("sky_distance", "normalization"))
def _ao_chunk(rects: RectsDev, centers, dirs, fac, sky_distance, normalization):
    """AO for a [C] texel chunk x [K] directions (photonmap.c:441-475)."""
    C, K = centers.shape[0], dirs.shape[0]
    src = (centers[:, None, :] + dirs[None, :, :] * 1e-5).reshape(C * K, 3)
    d = jnp.broadcast_to(dirs[None, :, :], (C, K, 3)).reshape(C * K, 3)
    dist = jnp.min(intersect_all(src, d, rects), axis=-1)
    dist = jnp.where(jnp.isfinite(dist), dist, sky_distance).reshape(C, K)
    dist_sum = jnp.sum(dist * fac[None, :], axis=-1)
    return dist_sum / (jnp.sum(fac) * normalization)


def render_ao(
    scene: Scene, rects: RectsDev, cfg: AoConfig, wall_indices=None
) -> np.ndarray:
    """Full AO pass over every wall; returns the [num_texels, 3] arena.

    `wall_indices` restricts the pass to a wall subset (texels of other
    walls stay zero) — AO is per-texel independent (photonmap.c:441), so a
    subset equals the corresponding slice of a full run; used to golden-test
    flagship-scale scenes without paying the full texel count."""
    texels = np.zeros((scene.num_texels, 3), f32)
    vs = geosphere(cfg.geosphere_level)
    fac = jnp.asarray(vs[:, 2])
    chunk = int(cfg.texels_per_chunk)
    walls = (
        scene.walls if wall_indices is None
        else [scene.walls[i] for i in wall_indices]
    )
    for wall in walls:
        dirs = jnp.asarray(wall_directions(wall.n, cfg.geosphere_level))
        centers = tile_centers(wall)
        T = num_tiles(wall)
        vals = np.empty(T, f32)
        for s in range(0, T, chunk):
            c = centers[s : s + chunk]
            pad = chunk - len(c)
            if pad:
                c = np.concatenate([c, np.zeros((pad, 3), f32)])
            out = np.asarray(
                _ao_chunk(
                    rects,
                    jnp.asarray(c),
                    dirs,
                    fac,
                    float(cfg.sky_distance),
                    float(cfg.normalization),
                )
            )
            vals[s : s + chunk] = out[: len(vals[s : s + chunk])]
        texels[wall.base : wall.base + T] = vals[:, None]
    return texels
