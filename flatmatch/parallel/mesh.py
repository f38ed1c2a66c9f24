"""Multi-device photon data parallelism.

The reference's only parallelism is photon-level DP on one OpenCL device
(/root/reference/photonmap.cl:269-281, global_illumination_cl.c:246-267;
SURVEY.md §2 "Parallelism & communication"). Here:

  - a 1-D `photons` mesh axis over all devices (NVLink between the cards of
    a host; the JAX runtime picks the transport, no custom backend)
  - the scene SoA and the lightmap arena are REPLICATED (they are tiny:
    O(100) rects, O(1e5-1e6) texels)
  - each device traces its slice of every photon batch with decorrelated
    draws and splats into a shard-local accumulator
  - shard accumulators are combined with one `jax.lax.psum` per segment —
    replacing the reference's single shared racy buffer with a collective
    reduction

Results are deterministic for a fixed (seed, device count) wherever the
splat is (on the CPU; the GPU's scatter-add is atomic, see ops/splat.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from ..config import PhotonConfig
from ..ops.device_scene import EmittersDev, RectsDev
from ..engines.photon import EmitterSlice, trace_cfg
from ..engines.schedule import run_schedule, trace_one_batch


def photon_mesh(devices=None) -> Mesh:
    """1-D device mesh over the photon axis."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=("photons",))


@functools.partial(
    jax.jit, static_argnames=("cfg", "batch_size", "mesh", "kernel")
)
def _trace_emitter_sharded(
    lightmap,
    scene,
    em: EmitterSlice,
    key,
    base_batch,
    batch_offset,
    seg_len,
    emitter_n_batches,
    last_batch_valid,
    cfg: PhotonConfig,
    batch_size: int,
    mesh: Mesh,
    kernel=None,
):
    """Batches [batch_offset, batch_offset+seg_len) of one emitter's photon
    budget, sharded over the `photons` mesh axis, on either engine
    (engines/schedule.trace_one_batch). Both engines key draws per (batch,
    device), so the sharded XLA and kernel engines trace identical photons.

    `batch_size` is the GLOBAL batch; each device traces batch_size/n_dev.
    """
    n_dev = mesh.shape["photons"]
    assert batch_size % n_dev == 0, "photons_per_batch must divide the mesh"
    b_local = batch_size // n_dev

    replicated = P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(replicated,) * 3,
        out_specs=replicated,
        check_vma=False,
    )
    def shard_fn(lightmap, scene, key):
        ax = jax.lax.axis_index("photons")

        def body(i, lm):
            abs_i = batch_offset + i
            n_valid_global = jnp.where(
                abs_i == emitter_n_batches - 1,
                last_batch_valid,
                jnp.int32(batch_size),
            )
            # photons [ax*b_local, (ax+1)*b_local) of the global batch
            n_valid_local = jnp.clip(
                n_valid_global - ax * b_local, 0, b_local
            ).astype(jnp.int32)
            return trace_one_batch(
                lm, scene, em, key, base_batch + abs_i, n_valid_local, cfg,
                b_local, kernel, ax=ax,
            )

        delta = jax.lax.fori_loop(0, seg_len, body, jnp.zeros_like(lightmap))
        # one collective per emitter segment: the replacement for the
        # reference's racy shared accumulator (photonmap.cl:256-258)
        return lightmap + jax.lax.psum(delta, "photons")

    return shard_fn(lightmap, scene, key)


def render_photons_sharded(
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
    mesh: Mesh = None,
    checkpoint_path: str = None,
    every_batches: "int | None" = None,
    on_segment=None,
    kernel=None,
    aa=None,
) -> jnp.ndarray:
    """Full photon pass sharded over all devices (windows then lights,
    global_illumination_cl.c:304-308). `kernel`/`aa` select the trace
    kernel as in engines/schedule.render_photons. Checkpoints (shared
    filesystem required multi-host: all hosts load, the primary writes)
    are fingerprinted with the device count — a resumed run must use the
    same mesh shape, since draws are keyed per (batch, device)."""
    from . import multihost

    mesh = mesh or photon_mesh()
    key = jax.random.PRNGKey(cfg.seed)
    B = int(cfg.photons_per_batch)
    n_dev = mesh.shape["photons"]
    if B % n_dev:
        B = ((B + n_dev - 1) // n_dev) * n_dev

    scene = rects if kernel is None else aa
    tcfg = trace_cfg(cfg)

    def trace_seg(lm, em, base_batch, off, seg, n_batches, last_valid):
        return _trace_emitter_sharded(
            lm, scene, em, key, base_batch, off, seg, n_batches,
            last_valid, tcfg, B, mesh, kernel,
        )

    return run_schedule(
        trace_seg,
        emitters,
        num_texels,
        cfg,
        B,
        checkpoint_path=checkpoint_path,
        every_batches=every_batches,
        fingerprint_extra=(
            "xla-sharded" if kernel is None else "kernel-sharded", n_dev
        ),
        write_checkpoints=multihost.is_primary(),
        on_segment=on_segment,
    )
