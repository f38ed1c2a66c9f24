"""Shared per-emitter photon dispatch schedule, and the choice between the
photon engines per batch.

Every photon engine (XLA, the GPU trace kernel, and their sharded variants)
runs the same outer schedule as the reference dispatch loop — every window
emitter, then every lamp (/root/reference/global_illumination_cl.c:304-308),
each with numSamples = samplesPerArea * area photons streamed in
fixed-shape batches. This module owns that loop once, including optional
checkpoint / resume: because the RNG is counter-based (keyed by the global
batch index), a resumed run traces exactly the photons the uninterrupted
run would have — bit-identical results where the splat is ordered (the
CPU; gated in tests/test_checkpoint.py).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PhotonConfig
from ..ops.device_scene import EmittersDev, RectsDev
from ..ops.splat import scatter_splat
from .photon import EmitterSlice, trace_batch, trace_cfg, uniforms_per_photon
from .photon_triton import (
    batch_seed, device_seed, emitter_vector, trace_batch_kernel,
    trace_deposits_rng,
)

# trace_seg(lightmap, em, base_batch, batch_offset, seg_len,
#           emitter_n_batches, last_batch_valid) -> lightmap
TraceSeg = Callable


def emitter_slice(emitters: EmittersDev, e: int) -> EmitterSlice:
    return EmitterSlice(
        pos=emitters.pos[e],
        wvec=emitters.wvec[e],
        hvec=emitters.hvec[e],
        n=emitters.n[e],
        color=emitters.color[e],
        is_window=emitters.is_window[e],
    )


def run_schedule(
    trace_seg: TraceSeg,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
    batch_size: int,
    checkpoint_path: Optional[str] = None,
    every_batches: "int | None" = None,
    fingerprint_extra=(),
    write_checkpoints: bool = True,
    on_segment: Optional[Callable] = None,
):
    """Run the full emitter schedule, optionally checkpointed.

    `fingerprint_extra` distinguishes engines / mesh shapes whose RNG
    schedules differ (a kernel-engine checkpoint must never resume an XLA
    render, nor an 8-device one a 4-device run). `write_checkpoints` is
    False on non-primary hosts: all hosts resume from the (shared-
    filesystem) checkpoint, only the primary writes it.

    `on_segment(lightmap, photons_done, photons_total)` fires after every
    completed segment — the incremental-result hook behind progressive
    tile previews (the analog of the reference browser port posting
    each wall's lightmap as it completes, /root/reference/worker.js:43-60).
    Returns the raw (un-normalized) [num_texels, 3] lightmap.
    """
    from ..utils import checkpoint as ckpt
    from ..utils.progress import info

    counts = np.asarray(emitters.counts)
    B = int(batch_size)
    if every_batches is None:
        every_batches = int(cfg.checkpoint_every)

    resume_e, resume_b = 0, 0
    lightmap = jnp.zeros((num_texels, 3), jnp.float32)
    fp = None
    if checkpoint_path is not None:
        fp = ckpt.config_fingerprint(
            cfg, num_texels, counts,
            extra=tuple(fingerprint_extra) + (B, every_batches),
        )
        state = ckpt.load(checkpoint_path, fp)
        if state is not None:
            arr, resume_e, resume_b = state
            lightmap = jnp.asarray(arr)
            info(
                f"resuming from {checkpoint_path}: emitter {resume_e}, "
                f"batch {resume_b}"
            )

    total_photons = int(counts.sum())
    base_batch = 0
    done_before = 0  # photons of fully completed PRIOR emitters
    for e in range(len(counts)):
        n = int(counts[e])
        if n == 0:
            continue
        n_batches = (n + B - 1) // B
        last_valid = n - (n_batches - 1) * B
        if e < resume_e:
            base_batch += n_batches
            done_before += n
            continue
        em = emitter_slice(emitters, e)
        start = resume_b if e == resume_e else 0
        # ALWAYS segment by every_batches, checkpointing or not: the sharded
        # engines psum once per segment, so identical segmentation is what
        # makes a checkpointed/resumed run bit-identical to a straight one
        step = every_batches
        for off in range(start, n_batches, max(step, 1)):
            seg = min(step, n_batches - off)
            lightmap = trace_seg(
                lightmap,
                em,
                jnp.int32(base_batch),
                jnp.int32(off),
                jnp.int32(seg),
                jnp.int32(n_batches),
                jnp.int32(last_valid),
            )
            if checkpoint_path is not None and write_checkpoints:
                nxt = off + seg
                cursor = (e, nxt) if nxt < n_batches else (e + 1, 0)
                ckpt.save(
                    checkpoint_path, np.asarray(lightmap), *cursor, fp
                )
            if checkpoint_path is not None:
                # fault injection (tests + chaos drills): hard-kill this
                # process after N checkpoint rounds, like a preempted host.
                # Counted on every process (the non-primary skips the write
                # but dies at the same point) so multi-process kills are
                # synchronized. The reference's failure story was
                # printf+exit (SURVEY.md §5); this makes ours testable.
                import os

                kill_after = os.environ.get(
                    "FLATMATCH_FAULT_EXIT_AFTER_CHECKPOINTS"
                )
                if kill_after is not None:
                    saves_done = getattr(run_schedule, "_fault_saves", 0) + 1
                    run_schedule._fault_saves = saves_done
                    if saves_done >= int(kill_after):
                        from ..utils.progress import warn

                        warn(
                            f"FAULT INJECTION: exiting after "
                            f"{saves_done} checkpoint rounds"
                        )
                        os._exit(17)
            if on_segment is not None:
                done = done_before + min((off + seg) * B, n)
                on_segment(lightmap, done, total_photons)
        base_batch += n_batches
        done_before += n
    return lightmap


def trace_one_batch(lightmap, scene, em: EmitterSlice, key, global_batch,
                    n_valid, cfg: PhotonConfig, batch_size: int,
                    kernel=None, ax=None):
    """Trace + splat one batch of the emitter schedule on either engine.

    `scene` is the engine's scene: RectsDev for the XLA engine (`kernel`
    None), AARectsDev for the trace kernel (`kernel` a KernelSpec). Draws
    are keyed by the absolute batch index (and the mesh position `ax` when
    sharded), so segmentation never changes a photon: threefry uniforms
    shared by both engines, or the kernel's counter hash with
    cfg.device_rng."""
    if kernel is not None and cfg.device_rng:
        seed = batch_seed(cfg.seed, global_batch)
        if ax is not None:
            seed = device_seed(seed, ax)
        idx, col = trace_deposits_rng(
            scene.fields, scene.base, emitter_vector(em), seed, n_valid,
            batch_size, cfg, kernel,
        )
        return scatter_splat(lightmap, idx, col)
    k = jax.random.fold_in(key, global_batch)
    if ax is not None:
        k = jax.random.fold_in(k, ax)
    U = uniforms_per_photon(cfg.max_depth)
    uniforms = jax.random.uniform(k, (batch_size, U), dtype=jnp.float32)
    if kernel is None:
        return trace_batch(lightmap, scene, em, uniforms, n_valid, cfg)
    return trace_batch_kernel(
        lightmap, scene, em, uniforms, n_valid, cfg, kernel
    )


@functools.partial(
    jax.jit, static_argnames=("cfg", "batch_size", "kernel")
)
def _trace_emitter(
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
    kernel=None,
):
    """Trace batches [batch_offset, batch_offset+seg_len) of one emitter's
    schedule. `base_batch` is the emitter's global key offset; segmenting
    exists so a host checkpoint loop can slice the schedule without changing
    any photon's draws (utils/checkpoint.py)."""

    def body(i, lm):
        abs_i = batch_offset + i
        n_valid = jnp.where(
            abs_i == emitter_n_batches - 1,
            last_batch_valid,
            jnp.int32(batch_size),
        )
        return trace_one_batch(
            lm, scene, em, key, base_batch + abs_i, n_valid, cfg,
            batch_size, kernel,
        )

    return jax.lax.fori_loop(0, seg_len, body, lightmap)


def render_photons(
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
    checkpoint_path: str = None,
    every_batches: "int | None" = None,
    on_segment=None,
    kernel=None,
    aa=None,
) -> jnp.ndarray:
    """Full photon pass: every window, then every light
    (global_illumination_cl.c:304-308). Returns the raw (un-normalized)
    [num_texels, 3] radiance arena. With `checkpoint_path`, periodic host
    checkpoints make an interrupted render resume bit-identically
    (run_schedule).

    `kernel` (a photon_triton.KernelSpec) traces on the GPU kernel over the
    axis-aligned scene `aa` (ops/aa_scene.pack_aa) instead of the XLA
    engine over `rects`."""
    key = jax.random.PRNGKey(cfg.seed)
    B = int(cfg.photons_per_batch)
    scene = rects if kernel is None else aa
    tcfg = trace_cfg(cfg)

    def trace_seg(lm, em, base_batch, off, seg, n_batches, last_valid):
        return _trace_emitter(
            lm, scene, em, key, base_batch, off, seg, n_batches,
            last_valid, tcfg, B, kernel,
        )

    return run_schedule(
        trace_seg,
        emitters,
        num_texels,
        cfg,
        B,
        checkpoint_path=checkpoint_path,
        every_batches=every_batches,
        fingerprint_extra=("xla",) if kernel is None else ("kernel",),
        on_segment=on_segment,
    )
