"""NumPy CPU oracle for the photon engine.

The reference validates its GPU kernel against a sequential CPU twin with the
same physics (photonmap.c:164-258 vs photonmap.cl:161-265 — SURVEY.md §4
"redundant engines as cross-checks"). This module plays that role here: an independent NumPy implementation of the same photon physics
that consumes the SAME uniform draws as the XLA path, so lightmaps must agree
to float tolerance at any photon count.

Everything is float32, mirroring the device math op-for-op.
"""
from __future__ import annotations

import numpy as np

from ..config import PhotonConfig
from ..ops.sampling import TWO_PI_REF

f32 = np.float32


def _build_base_np(ndir):
    """build_base twin (photonmap.cl:43-48). ndir: [B,3]."""
    z = np.zeros_like(ndir)
    z[:, 2] = 1.0
    y = np.zeros_like(ndir)
    y[:, 1] = 1.0
    colinear = np.abs(np.sum(z * ndir, -1)) >= 0.999999
    udir = np.where(colinear[:, None], y, z)
    vdir = np.cross(udir, ndir).astype(f32)
    vdir /= np.sqrt(np.sum(vdir * vdir, -1))[:, None]
    udir = np.cross(vdir, ndir).astype(f32)
    udir /= np.sqrt(np.sum(udir * udir, -1))[:, None]
    return udir, vdir


def _hemisphere_dir_np(u1, u2, ndir, fold):
    r = np.sqrt(u1, dtype=f32)
    phi = f32(TWO_PI_REF) * u2
    u = r * np.cos(phi, dtype=f32)
    v = r * np.sin(phi, dtype=f32)
    n = np.sqrt(f32(1.0) - r * r, dtype=f32)
    if np.ndim(fold) == 0:
        u = np.abs(u) if fold else u
    else:
        u = np.where(fold, np.abs(u), u)
    udir, vdir = _build_base_np(ndir)
    return udir * u[:, None] + vdir * v[:, None] + ndir * n[:, None]


def _nearest_hit_np(src, direc, rects):
    """Brute-force nearest front-face hit (rectangle.c:67-95 over all rects).

    `rects` is an ops.device_scene.RectsDev (NumPy views are taken)."""
    n = np.asarray(rects.n)
    pos_r = np.asarray(rects.pos)
    w_u = np.asarray(rects.w_unit)
    h_u = np.asarray(rects.h_unit)
    wlen = np.asarray(rects.wlen)
    hlen = np.asarray(rects.hlen)
    n_off = np.asarray(rects.n_off)

    denom = direc @ n.T
    with np.errstate(divide="ignore", invalid="ignore"):
        fac = (n_off[None, :] - src @ n.T) / denom
    dx = src @ w_u.T + fac * (direc @ w_u.T) - np.sum(w_u * pos_r, -1)
    dy = src @ h_u.T + fac * (direc @ h_u.T) - np.sum(h_u * pos_r, -1)
    valid = (
        (denom < 0)
        & (fac >= 0)
        & (dx >= 0)
        & (dx <= wlen[None, :])
        & (dy >= 0)
        & (dy <= hlen[None, :])
    )
    dist = np.where(valid, fac, np.inf).astype(f32)
    hit = np.argmin(dist, axis=-1).astype(np.int32)
    return np.min(dist, axis=-1), hit


def _texel_index_np(rects, hit, p):
    """getTileIdAt twin (rectangle.c:205-230)."""
    pos_r = np.asarray(rects.pos)[hit]
    w_u = np.asarray(rects.w_unit)[hit]
    h_u = np.asarray(rects.h_unit)[hit]
    wlen = np.asarray(rects.wlen)[hit]
    hlen = np.asarray(rects.hlen)[hit]
    wt = np.asarray(rects.wtiles)[hit]
    ht = np.asarray(rects.htiles)[hit]
    base = np.asarray(rects.base)[hit]
    pdir = p - pos_r
    dx = np.sum(w_u * pdir, -1, dtype=f32)
    dy = np.sum(h_u * pdir, -1, dtype=f32)
    # keep the tile math in float32 like the device path (int32 operands
    # would promote the product to float64 and shift tile-boundary rounding)
    tx = np.clip((dx * wt.astype(f32) / wlen).astype(np.int32), 0, wt - 1)
    ty = np.clip((dy * ht.astype(f32) / hlen).astype(np.int32), 0, ht - 1)
    return base + ty * wt + tx


def trace_batch_np(
    lightmap: np.ndarray,
    rects,
    em_pos,
    em_wvec,
    em_hvec,
    em_n,
    em_color,
    is_window: bool,
    uniforms: np.ndarray,
    n_valid: int,
    cfg: PhotonConfig,
) -> np.ndarray:
    """NumPy twin of engines.photon.trace_batch (same uniforms layout)."""
    B = uniforms.shape[0]
    uniforms = uniforms.astype(f32)
    eps = f32(cfg.self_intersect_eps)
    ndir = np.broadcast_to(np.asarray(em_n, f32), (B, 3))
    direc = _hemisphere_dir_np(
        uniforms[:, 2], uniforms[:, 3], np.ascontiguousarray(ndir), is_window
    )
    pos = (
        np.asarray(em_pos, f32)[None, :]
        + np.asarray(em_wvec, f32)[None, :] * uniforms[:, 0:1]
        + np.asarray(em_hvec, f32)[None, :] * uniforms[:, 1:2]
        + direc * eps
    )
    color = np.broadcast_to(np.asarray(em_color, f32), (B, 3)).copy()
    alive = np.arange(B) < n_valid
    tint = np.asarray(cfg.floor_tint, f32)

    for d in range(cfg.max_depth):
        dist, hit = _nearest_hit_np(pos, direc, rects)
        hitmask = np.isfinite(dist)
        alive = alive & hitmask
        pos = pos + direc * np.where(hitmask, dist, 0)[:, None]
        idx = _texel_index_np(rects, hit, pos)
        n_hit = np.asarray(rects.n)[hit]

        u_rr = uniforms[:, 4 + 3 * d]
        diffuse = (pos[:, 2] > cfg.mirror_z_threshold) | (u_rr > cfg.rr_mirror_prob)

        dir_diffuse = _hemisphere_dir_np(
            uniforms[:, 5 + 3 * d], uniforms[:, 6 + 3 * d], n_hit, False
        )
        dir_mirror = direc - 2.0 * np.sum(n_hit * direc, -1)[:, None] * n_hit

        tint_fac = np.where(
            (pos[:, 2] < cfg.floor_tint_z_threshold)[:, None], tint[None, :], f32(1.0)
        )
        color_diffuse = color * tint_fac * f32(cfg.albedo)
        color = np.where(diffuse[:, None], color_diffuse, color)
        direc = np.where(diffuse[:, None], dir_diffuse, dir_mirror).astype(f32)

        contrib = np.where(alive[:, None], color, f32(0.0))
        np.add.at(lightmap, idx, contrib)

        pos = (pos + direc * eps).astype(f32)

    return lightmap
