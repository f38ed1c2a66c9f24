"""Batched ray-rectangle intersection (the innermost hot loop).

The reference brute-forces every rect per ray segment on the GPU
(/root/reference/photonmap.cl:123-158,194-206) — the right call for a scene
of O(100) rects: the [B,3] x [3,N] projections below are elementwise work
that XLA fuses into a handful of kernels, with no gather, no tree, no
divergence. The BSP tree of
the native engine (photonmap.c:20-27) is deliberately NOT ported — it was a
CPU-only optimization (SURVEY.md §7).

Geometry per rect, mirroring intersects() (rectangle.c:67-95):
  denom = dot(n, dir)         reject denom >= 0  (backface / parallel)
  fac   = dot(n, pos_r - src) / denom             reject fac < 0 (behind)
  p     = src + dir * fac
  dx    = dot(width/|width|, p - pos_r)           reject outside [0, |width|]
  dy    = dot(height/|height|, p - pos_r)         reject outside [0, |height|]
The early-out against the closest hit (rectangle.c:82-83) becomes the min
reduction over the rect axis.
"""
from __future__ import annotations

import jax.numpy as jnp

from .device_scene import RectsDev

INF = jnp.inf


def _dot3(a, bT):
    """Exact-f32 [B,3] x [3,N] contraction as explicit component broadcasts.

    NOT a matmul on purpose: an accelerator may run an f32 `a @ bT` at
    reduced precision (TF32 on the GPU's tensor cores, bf16 elsewhere),
    which truncates ray origins (12.525 -> 12.5) and turns grazing-distance
    tests into garbage hits (found on hardware: fac computed -0.0 for a
    rect 0.128 m BEHIND the ray). A K=3 contraction is 3 mul-adds — cheaper
    than a padded matrix pass and exactly f32 on every backend."""
    return (
        a[:, 0:1] * bT[0][None, :]
        + a[:, 1:2] * bT[1][None, :]
        + a[:, 2:3] * bT[2][None, :]
    )


def intersect_all(src, direc, rects: RectsDev):
    """Distances from rays [B,3] to every rect: returns dist [B,N] with +inf
    where the rect is missed."""
    nT = rects.n.T          # [3,N]
    wT = rects.w_unit.T
    hT = rects.h_unit.T
    denom = _dot3(direc, nT)                               # [B,N]
    fac = (rects.n_off[None, :] - _dot3(src, nT)) / denom  # [B,N]
    # dx = dot(w_unit, src + dir*fac - rect_pos), expanded so no [B,N,3]
    # intermediate is ever materialized.
    dx = (
        _dot3(src, wT) + fac * _dot3(direc, wT)
        - jnp.sum(rects.w_unit * rects.pos, -1)
    )
    dy = (
        _dot3(src, hT) + fac * _dot3(direc, hT)
        - jnp.sum(rects.h_unit * rects.pos, -1)
    )
    valid = (
        (denom < 0)
        & (fac >= 0)
        & (dx >= 0)
        & (dx <= rects.wlen[None, :])
        & (dy >= 0)
        & (dy <= rects.hlen[None, :])
    )
    return jnp.where(valid, fac, INF)


def nearest_hit(src, direc, rects: RectsDev):
    """Closest front-face hit per ray.

    Returns (dist [B], hit [B] int32). dist == +inf means no hit; `hit` is
    then arbitrary (0) and must be masked by the caller.
    """
    dist = intersect_all(src, direc, rects)
    hit = jnp.argmin(dist, axis=-1).astype(jnp.int32)
    return jnp.min(dist, axis=-1), hit
