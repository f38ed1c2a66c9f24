"""Full-pipeline NumPy photon render (the PHOTON_ORACLE engine).

Drives engines/oracle.py over every emitter with EXACTLY the same uniform
draws (same threefry key schedule, same batch layout) as the XLA engine
(engines/photon.py), so the two lightmaps must agree to float tolerance.
This is the analog of the reference's PHOTON_NATIVE
CPU-oracle mode (/root/reference/main.c:14,62; photonmap.c:408-434).
"""
from __future__ import annotations

import jax
import numpy as np

from ..config import PhotonConfig
from ..ops.device_scene import pack_emitters, pack_rects
from ..scene.geometry import Scene
from .oracle import trace_batch_np
from .photon import uniforms_per_photon

f32 = np.float32


def render_photons_np(scene: Scene, cfg: PhotonConfig) -> np.ndarray:
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    lightmap = np.zeros((scene.num_texels, 3), f32)
    key = jax.random.PRNGKey(cfg.seed)
    B = int(cfg.photons_per_batch)
    U = uniforms_per_photon(cfg.max_depth)
    counts = np.asarray(emitters.counts)
    base_batch = 0
    for e in range(len(counts)):
        n = int(counts[e])
        if n == 0:
            continue
        n_batches = (n + B - 1) // B
        for i in range(n_batches):
            k = jax.random.fold_in(key, base_batch + i)
            uniforms = np.asarray(jax.random.uniform(k, (B, U), dtype=np.float32))
            n_valid = B if i < n_batches - 1 else n - (n_batches - 1) * B
            lightmap = trace_batch_np(
                lightmap,
                rects,
                np.asarray(emitters.pos[e]),
                np.asarray(emitters.wvec[e]),
                np.asarray(emitters.hvec[e]),
                np.asarray(emitters.n[e]),
                np.asarray(emitters.color[e]),
                bool(emitters.is_window[e]),
                uniforms,
                n_valid,
                cfg,
            )
        base_batch += n_batches
    return lightmap
