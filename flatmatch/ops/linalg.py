"""Small batched 3-vector helpers (jnp, float32).

The reference's Vector3 math (/root/reference/vector3_cl.c:8-100) becomes
batched jnp ops over a trailing xyz axis. Everything stays float32 — the
renderer is bound by elementwise work and memory, not by matrix units, and
lightmap addressing needs f32
precision.
"""
from __future__ import annotations

import jax.numpy as jnp


def dot3(a, b):
    """Batched dot product over the trailing xyz axis (vector3_cl.c:76-79)."""
    return jnp.sum(a * b, axis=-1)


def cross3(a, b):
    """Batched cross product (vector3_cl.c:81-86)."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def normalize3(a):
    """Normalization via reciprocal length (vector3_cl.c:95-100)."""
    fac = 1.0 / jnp.sqrt(dot3(a, a))
    return a * fac[..., None]
