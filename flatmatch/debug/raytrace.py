"""Debug first-hit raytracer: visual verification of scene geometry.

Equivalent of the reference's standalone harness
(/root/reference/debugRaytracer.cc:108-200): render the parsed scene from an
interior pinhole camera, coloring every pixel by the index of the rect its
primary ray hits (5-level RGB cube per index, colorRects,
debugRaytracer.cc:83-96). The reference eyeballed the PNG; here the render is
also a regression artifact (tests hash it) and doubles as a correctness
probe for the vectorized intersector — every pixel is one ray through
ops.intersect.nearest_hit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.device_scene import RectsDev
from ..ops.intersect import nearest_hit
from ..scene.geometry import Scene

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera matching debugRaytracer.cc:120-124,148-156: the screen
    plane sits 1m along `direction`, pixels step `pixel_pitch` meters along
    camera-right / negative camera-up."""

    position: tuple = (5.0, 5.2, 1.6)
    direction: tuple = (1.0, 1.0, 0.0)  # normalized internally
    up: tuple = (0.0, 0.0, 1.0)
    width: int = 1024
    height: int = 768
    pixel_pitch: float = 1 / 1000.0 * 4  # reference dx at 4096 wide, scaled


def rect_index_colors(n: int) -> np.ndarray:
    """5-level RGB color cube by rect index (colorRects,
    debugRaytracer.cc:83-96)."""
    i = np.arange(n)
    return np.stack(
        [(i % 5) * 51, ((i // 5) % 5) * 51, ((i // 25) % 5) * 51], axis=-1
    ).astype(np.uint8)


def render_first_hit(
    scene: Scene, rects: RectsDev, camera: Camera = Camera()
) -> np.ndarray:
    """[H, W, 4] RGBA first-hit render; un-hit pixels stay transparent black
    (the reference leaves them at the createImage default)."""
    cam_pos = np.asarray(camera.position, f32)
    cam_dir = np.asarray(camera.direction, f32)
    cam_dir = cam_dir / np.linalg.norm(cam_dir)
    cam_up = np.asarray(camera.up, f32)
    cam_right = np.cross(cam_dir, cam_up).astype(f32)

    w, h = camera.width, camera.height
    xs = (np.arange(w) - w // 2) * f32(camera.pixel_pitch)
    ys = -(np.arange(h) - h // 2) * f32(camera.pixel_pitch)
    screen = (
        (cam_pos + cam_dir)[None, None, :]
        + xs[None, :, None] * cam_right[None, None, :]
        + ys[:, None, None] * cam_up[None, None, :]
    ).astype(f32)
    dirs = screen - cam_pos[None, None, :]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    dirs_flat = jnp.asarray(dirs.reshape(-1, 3))
    src = jnp.broadcast_to(jnp.asarray(cam_pos), dirs_flat.shape)
    dist, hit = jax.jit(nearest_hit)(src, dirs_flat, rects)
    dist = np.asarray(dist)
    hit = np.asarray(hit)

    colors = rect_index_colors(len(scene.walls))
    img = np.zeros((h * w, 4), np.uint8)
    hitmask = np.isfinite(dist)
    img[hitmask, :3] = colors[hit[hitmask] % len(colors)]
    img[hitmask, 3] = 255
    return img.reshape(h, w, 4)
