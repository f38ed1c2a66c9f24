"""Hemisphere samplers as pure functions of uniform draws (jnp, float32).

The reference samples with stateful RNGs (LCG on device, photonmap.cl:21-25;
libc rand() on host, vector3_cl.c:107-108). Here randomness is
separated from geometry: samplers take uniform draws in [0,1] as explicit
arguments, so the same function serves the threefry-keyed production path and
the NumPy parity oracle, and gradients can flow through the geometry while the
draws stay constant.

Distributions match the reference exactly:
  - cosine-weighted hemisphere via unit-disk projection
    (photonmap.cl:54-74, vector3_cl.c:129-149)
  - "diffuse sky" quarter-sphere fold (u = |u|, "no light from below the
    horizon", photonmap.cl:27-52, vector3_cl.c:102-127)
  - orthonormal base with z-up fallback to y-up when (nearly) colinear
    (photonmap.cl:43-48, vector3_cl.c:152-170)
"""
from __future__ import annotations

import jax.numpy as jnp

from .linalg import cross3, dot3, normalize3

# The reference uses this truncated pi literal (photonmap.cl:33,57).
TWO_PI_REF = 2.0 * 3.141592


def build_base(ndir):
    """Orthonormal (udir, vdir) completing `ndir` (photonmap.cl:43-48).

    udir starts as +z and falls back to +y when |dot(z, ndir)| >= 0.999999.
    """
    z = jnp.zeros_like(ndir).at[..., 2].set(1.0)
    y = jnp.zeros_like(ndir).at[..., 1].set(1.0)
    colinear = jnp.abs(dot3(z, ndir)) >= 0.999999
    udir = jnp.where(colinear[..., None], y, z)
    vdir = normalize3(cross3(udir, ndir))
    udir = normalize3(cross3(vdir, ndir))
    return udir, vdir


def _disk_to_hemisphere(u1, u2):
    """Uniform disk point + hemisphere projection (photonmap.cl:31-38)."""
    r = jnp.sqrt(u1)
    phi = jnp.float32(TWO_PI_REF) * u2
    u = r * jnp.cos(phi)
    v = r * jnp.sin(phi)
    n = jnp.sqrt(1.0 - r * r)
    return u, v, n


def cosine_ray(u1, u2, ndir):
    """Cosine-weighted hemisphere direction around `ndir`
    (photonmap.cl:54-74)."""
    u, v, n = _disk_to_hemisphere(u1, u2)
    udir, vdir = build_base(ndir)
    return udir * u[..., None] + vdir * v[..., None] + ndir * n[..., None]


def sky_ray(u1, u2, ndir):
    """Quarter-sphere "diffuse sky" direction around `ndir`: the disk point's
    u coordinate is folded positive so no light arrives from below the horizon
    (photonmap.cl:27-52)."""
    u, v, n = _disk_to_hemisphere(u1, u2)
    u = jnp.abs(u)  # photonmap.cl:40-41
    udir, vdir = build_base(ndir)
    return udir * u[..., None] + vdir * v[..., None] + ndir * n[..., None]


def transform_to_base(vec, b0, b1, b2):
    """Column-mixing base transform res = x*b0 + y*b1 + z*b2
    (photonmap.c:31-48), used by ambient occlusion to rotate geodesic
    directions into the surface frame."""
    return (
        b0 * vec[..., 0:1] + b1 * vec[..., 1:2] + b2 * vec[..., 2:3]
    )
