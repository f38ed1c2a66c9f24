"""Photon-mapping engine, plain XLA path (any backend; the reference the
GPU trace kernel, engines/photon_triton.py, is tested against).

Physics mirrors the reference device kernel tracePhoton
(/root/reference/photonmap.cl:161-265) exactly:
  - emit from a uniform point on the emitter, offset 1e-5 along the ray
  - window emitters use the quarter-sphere sky sampler, lamps the cosine
    sampler (photonmap.cl:177-179)
  - fixed 8-bounce loop; brute-force nearest intersection over all rects
  - Russian roulette at the floor (z <= 5e-4): 75% mirror, else diffuse
    (photonmap.cl:236-254)
  - diffuse: cosine resample, x0.9 albedo, floor tint (1, .85, .7) if
    z < 1e-5 — tint applied before the albedo multiply (photonmap.cl:238-249)
  - deposit the post-attenuation color into the hit texel
    (photonmap.cl:256-258)

Re-design decisions (SURVEY.md §7):
  - the LCG RNG (photonmap.cl:21-25) is replaced by counter-based threefry
    keyed per (emitter batch); samplers take the uniforms explicitly so the
    NumPy oracle (engines/oracle.py) can share the exact draws
  - the racy non-atomic `+=` splat (photonmap.cl:256 FIXME) becomes an XLA
    scatter-add over the batch's deposit stream (ops/splat.py): no lost
    updates; deterministic on the CPU, atomic (order-dependent sums) on
    the GPU
  - the early-return on miss becomes an `alive` mask over a fixed-depth loop
  - per-emitter photon budgets numSamples = samplesPerArea * area
    (photonmap.c:417-418) are driven by a host loop over emitters, like the
    reference dispatch (global_illumination_cl.c:304-308), with a
    `lax.fori_loop` over fixed-shape photon batches per emitter
    (engines/schedule.py, which also picks this engine or the kernel)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PhotonConfig
from ..ops.device_scene import RectsDev
from ..ops.intersect import nearest_hit
from ..ops.linalg import dot3
from ..ops.sampling import TWO_PI_REF, build_base
from ..ops.splat import scatter_splat
from ..ops.tile import texel_index


# texel id of a dead photon's deposit: out of range, so the splat drops it
DEAD = np.iinfo(np.int32).max


class EmitterSlice(NamedTuple):
    """One emitter's fields, as traced scalars/vectors."""

    pos: jnp.ndarray       # [3]
    wvec: jnp.ndarray      # [3]
    hvec: jnp.ndarray      # [3]
    n: jnp.ndarray         # [3]
    color: jnp.ndarray     # [3]
    is_window: jnp.ndarray  # bool scalar


def uniforms_per_photon(max_depth: int) -> int:
    """Draw layout: [dx, dy, dir_u1, dir_u2, (rr, u1, u2) x depth]."""
    return 4 + 3 * max_depth


def emit(em: EmitterSlice, uniforms, eps: float):
    """Sample emission points + initial directions for a batch.

    Columns 0-1: uniform point on the emitter rect (photonmap.cl:173-174);
    columns 2-3: disk sample for the direction. Windows fold the disk's u
    coordinate positive (sky quarter-sphere, photonmap.cl:40-41).
    """
    dx, dy = uniforms[:, 0], uniforms[:, 1]
    r = jnp.sqrt(uniforms[:, 2])
    phi = jnp.float32(TWO_PI_REF) * uniforms[:, 3]
    u = r * jnp.cos(phi)
    v = r * jnp.sin(phi)
    nz = jnp.sqrt(1.0 - r * r)
    u = jnp.where(em.is_window, jnp.abs(u), u)
    ndir = jnp.broadcast_to(em.n, (uniforms.shape[0], 3))
    udir, vdir = build_base(ndir)
    direc = udir * u[:, None] + vdir * v[:, None] + ndir * nz[:, None]
    pos = (
        em.pos[None, :]
        + em.wvec[None, :] * dx[:, None]
        + em.hvec[None, :] * dy[:, None]
        + direc * eps
    )
    return pos, direc


def trace_deposits(
    rects: RectsDev,
    em: EmitterSlice,
    uniforms: jnp.ndarray,
    n_valid,
    cfg: PhotonConfig,
    albedo: Optional[jnp.ndarray] = None,
    power: Optional[jnp.ndarray] = None,
):
    """Trace one fixed-shape photon batch: returns the deposit stream
    (texel ids [D, B] int32, colors [3, D, B]) — one deposit per photon
    and bounce; dead photons deposit id DEAD with zero color.

    `albedo` is an optional per-rect [N] array (differentiable path); when
    None the scalar cfg.albedo applies uniformly. `power` optionally scales
    the emitter color (differentiable emitter strength).
    """
    B = uniforms.shape[0]
    eps = jnp.float32(cfg.self_intersect_eps)
    floor_tint = jnp.asarray(cfg.floor_tint, jnp.float32)

    pos, direc = emit(em, uniforms, eps)
    color = jnp.broadcast_to(em.color, (B, 3)).astype(jnp.float32)
    if power is not None:
        color = color * power
    alive = jnp.arange(B, dtype=jnp.int32) < n_valid

    ids, cols = [], []
    for d in range(cfg.max_depth):
        dist, hit = nearest_hit(pos, direc, rects)
        hitmask = jnp.isfinite(dist)
        alive = alive & hitmask
        dist_safe = jnp.where(hitmask, dist, 0.0)
        pos = pos + direc * dist_safe[:, None]
        idx = texel_index(rects, hit, pos)
        n_hit = rects.n[hit]

        u_rr = uniforms[:, 4 + 3 * d]
        u1 = uniforms[:, 5 + 3 * d]
        u2 = uniforms[:, 6 + 3 * d]

        # Russian roulette: diffuse unless at the reflective floor and the
        # 75% mirror branch wins (photonmap.cl:236).
        diffuse = (pos[:, 2] > cfg.mirror_z_threshold) | (u_rr > cfg.rr_mirror_prob)

        r = jnp.sqrt(u1)
        phi = jnp.float32(TWO_PI_REF) * u2
        du = r * jnp.cos(phi)
        dv = r * jnp.sin(phi)
        dn = jnp.sqrt(1.0 - r * r)
        udir, vdir = build_base(n_hit)
        dir_diffuse = udir * du[:, None] + vdir * dv[:, None] + n_hit * dn[:, None]
        dir_mirror = direc - 2.0 * dot3(n_hit, direc)[:, None] * n_hit

        tint = jnp.where(
            (pos[:, 2] < cfg.floor_tint_z_threshold)[:, None],
            floor_tint[None, :],
            jnp.ones((1, 3), jnp.float32),
        )
        alb = (
            jnp.float32(cfg.albedo)
            if albedo is None
            else albedo[hit][:, None].astype(jnp.float32)
        )
        color_diffuse = color * tint * alb
        color = jnp.where(diffuse[:, None], color_diffuse, color)
        direc = jnp.where(diffuse[:, None], dir_diffuse, dir_mirror)

        ids.append(jnp.where(alive, idx, DEAD))
        cols.append(jnp.where(alive[:, None], color, 0.0).T)

        pos = pos + direc * eps

    return jnp.stack(ids), jnp.stack(cols, axis=1)


def trace_batch(
    lightmap: jnp.ndarray,
    rects: RectsDev,
    em: EmitterSlice,
    uniforms: jnp.ndarray,
    n_valid,
    cfg: PhotonConfig,
    albedo: Optional[jnp.ndarray] = None,
    power: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Trace one fixed-shape photon batch and splat into the lightmap."""
    idx, col = trace_deposits(rects, em, uniforms, n_valid, cfg, albedo, power)
    return scatter_splat(lightmap, idx, col)


def trace_cfg(cfg: PhotonConfig) -> PhotonConfig:
    """cfg with the fields no batch trace reads set to fixed values, so a
    change of budget or checkpoint cadence reuses the compiled trace."""
    return dataclasses.replace(cfg, samples_per_area=0.0, checkpoint_every=0)
