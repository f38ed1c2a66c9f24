"""Differentiable photon rendering: gradients w.r.t. per-surface albedo and
per-emitter power.

The reference renderer is not differentiable — this is new capability
(BASELINE.md north-star: "albedo-gradient allclose vs an autodiff
oracle"). Parameterization:

  - `albedo` [N_rects]: per-rect diffuse reflectance, replacing the global
    0.9 constant (photonmap.cl:249)
  - `power`  [N_emitters]: scalar multiplier on each emitter's flux color
    (photonmap.cl:167-169)

Key physics fact exploited by the backward pass: photon TRAJECTORIES depend
only on the RNG draws and the geometry — never on albedo or power (the
Russian-roulette branch compares a uniform against the fixed 0.75, and
directions are resampled geometrically). Only deposited magnitudes are
parameter-dependent, and each deposit is

    deposit(d) = power[e] * base_color * prod_{diffuse hits k<=d} albedo[r_k] * tint_k

so the whole lightmap is linear in power and polynomial in albedo. The
custom VJPs below therefore save only the PARAMETERS as residuals and
REPLAY the forward trajectories from the same threefry counters per batch
in the backward (SURVEY.md §7 step 6). Within one replayed batch the
backward uses jax.vjp over trace_batch (standard per-batch autodiff
residuals, bounded by the batch size).
"""
from __future__ import annotations

import functools


import jax
import jax.numpy as jnp
import numpy as np

from ..config import PhotonConfig
from ..ops.device_scene import EmittersDev, RectsDev
from ..engines import schedule as schedule_mod
from ..engines.photon import trace_batch, uniforms_per_photon


def _emitter_batches(counts, batch_size):
    out = []
    base_batch = 0
    for e in range(len(counts)):
        n = int(counts[e])
        if n == 0:
            continue
        n_batches = (n + batch_size - 1) // batch_size
        last_valid = n - (n_batches - 1) * batch_size
        out.append((e, base_batch, n_batches, last_valid))
        base_batch += n_batches
    return out


def make_diff_renderer(
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
):
    """Returns a differentiable fn(albedo [N], power [E]) -> lightmap [T,3].

    Deterministic for fixed cfg.seed; gradients via trajectory replay.
    """
    B = int(cfg.photons_per_batch)
    U = uniforms_per_photon(cfg.max_depth)
    schedule = _emitter_batches(np.asarray(emitters.counts), B)
    key = jax.random.PRNGKey(cfg.seed)

    def emitter_slice(e):
        return schedule_mod.emitter_slice(emitters, e)

    def batch_uniforms(batch_idx):
        k = jax.random.fold_in(key, batch_idx)
        return jax.random.uniform(k, (B, U), dtype=jnp.float32)

    def n_valid(i, n_batches, last_valid):
        return jnp.where(
            i == n_batches - 1, jnp.int32(last_valid), jnp.int32(B)
        )

    def forward_loop(albedo, power):
        """Plain forward accumulation over every emitter's batches."""
        lm = jnp.zeros((num_texels, 3), jnp.float32)
        for e, base_batch, n_batches, last_valid in schedule:
            em = emitter_slice(e)

            def body(i, lm, em=em, e=e, base_batch=base_batch,
                     n_batches=n_batches, last_valid=last_valid):
                u = batch_uniforms(base_batch + i)
                return trace_batch(
                    lm, rects, em, u, n_valid(i, n_batches, last_valid), cfg,
                    albedo=albedo, power=power[e],
                )

            lm = jax.lax.fori_loop(0, n_batches, body, lm)
        return lm

    @jax.custom_vjp
    def render(albedo, power):
        return forward_loop(albedo, power)

    def render_fwd(albedo, power):
        # residuals: just the parameters — trajectories replay from RNG
        return forward_loop(albedo, power), (albedo, power)

    def render_bwd(res, g):
        albedo, power = res
        d_albedo = jnp.zeros_like(albedo)
        d_power = jnp.zeros_like(power)
        for e, base_batch, n_batches, last_valid in schedule:
            em = emitter_slice(e)

            def body(i, carry, em=em, e=e, base_batch=base_batch,
                     n_batches=n_batches, last_valid=last_valid):
                da, dp = carry
                u = batch_uniforms(base_batch + i)

                def delta(a, p):
                    return trace_batch(
                        jnp.zeros((num_texels, 3), jnp.float32),
                        rects, em, u,
                        n_valid(i, n_batches, last_valid), cfg,
                        albedo=a, power=p,
                    )

                _, vjp_fn = jax.vjp(delta, albedo, power[e])
                da_b, dp_b = vjp_fn(g)
                return da + da_b, dp.at[e].add(dp_b)

            d_albedo, d_power = jax.lax.fori_loop(
                0, n_batches, body, (d_albedo, d_power)
            )
        return d_albedo, d_power

    render.defvjp(render_fwd, render_bwd)
    return jax.jit(render)


def make_diff_renderer_sharded(
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
    mesh,
):
    """Multi-chip differentiable renderer: photon DP over the `photons` mesh
    axis with psum-reduced lightmaps AND psum-reduced parameter cotangents.

    On overlap (amending SURVEY §7 step 6's "overlap gradient psum with
    backward replay"): the parameter cotangents here are O(N_rects +
    N_emitters) ~ 1 KB, one psum per backward — there is no transfer worth
    hiding behind compute. That design note applies to frameworks with
    large gradients; this workload's only meaningful collective is the
    forward lightmap psum ([T, 3] per emitter), which XLA's async
    collective scheduler already overlaps where profitable.

    Deterministic for fixed (seed, device count). Forward and backward use
    the same per-(batch, device) threefry keys, so the backward replays the
    exact forward trajectories shard-locally; only the [N]+[E] cotangent
    psum crosses chips.
    """
    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map
    n_dev = mesh.shape["photons"]
    B = int(cfg.photons_per_batch)
    if B % n_dev:
        B = ((B + n_dev - 1) // n_dev) * n_dev
    b_local = B // n_dev
    U = uniforms_per_photon(cfg.max_depth)
    schedule = _emitter_batches(np.asarray(emitters.counts), B)
    key = jax.random.PRNGKey(cfg.seed)
    repl = P()

    def emitter_slice(e):
        return schedule_mod.emitter_slice(emitters, e)

    def local_uniforms(batch_idx, ax):
        k = jax.random.fold_in(key, batch_idx)
        k = jax.random.fold_in(k, ax)
        return jax.random.uniform(k, (b_local, U), dtype=jnp.float32)

    def local_n_valid(i, ax, n_batches, last_valid):
        n_valid_global = jnp.where(
            i == n_batches - 1, jnp.int32(last_valid), jnp.int32(B)
        )
        return jnp.clip(n_valid_global - ax * b_local, 0, b_local).astype(
            jnp.int32
        )

    def forward_loop(albedo, power):
        @functools.partial(
            shard_map, mesh=mesh, in_specs=(repl, repl),
            out_specs=repl, check_vma=False,
        )
        def run(albedo, power):
            ax = jax.lax.axis_index("photons")
            lm = jnp.zeros((num_texels, 3), jnp.float32)
            for e, base_batch, n_batches, last_valid in schedule:
                em = emitter_slice(e)

                def body(i, lm, em=em, e=e, base_batch=base_batch,
                         n_batches=n_batches, last_valid=last_valid):
                    u = local_uniforms(base_batch + i, ax)
                    return trace_batch(
                        lm, rects, em, u,
                        local_n_valid(i, ax, n_batches, last_valid), cfg,
                        albedo=albedo, power=power[e],
                    )

                lm = jax.lax.fori_loop(0, n_batches, body, lm)
            return jax.lax.psum(lm, "photons")

        return run(albedo, power)

    @jax.custom_vjp
    def render(albedo, power):
        return forward_loop(albedo, power)

    def render_fwd(albedo, power):
        return forward_loop(albedo, power), (albedo, power)

    def render_bwd(res, g):
        albedo, power = res

        @functools.partial(
            shard_map, mesh=mesh, in_specs=(repl, repl, repl),
            out_specs=(repl, repl), check_vma=False,
        )
        def run(albedo, power, g):
            ax = jax.lax.axis_index("photons")
            d_albedo = jnp.zeros_like(albedo)
            d_power = jnp.zeros_like(power)
            for e, base_batch, n_batches, last_valid in schedule:
                em = emitter_slice(e)

                def body(i, carry, em=em, e=e, base_batch=base_batch,
                         n_batches=n_batches, last_valid=last_valid):
                    da, dp = carry
                    u = local_uniforms(base_batch + i, ax)
                    nv = local_n_valid(i, ax, n_batches, last_valid)

                    def delta(a, p):
                        return trace_batch(
                            jnp.zeros((num_texels, 3), jnp.float32),
                            rects, em, u, nv, cfg, albedo=a, power=p,
                        )

                    _, vjp_fn = jax.vjp(delta, albedo, power[e])
                    da_b, dp_b = vjp_fn(g)
                    return da + da_b, dp.at[e].add(dp_b)

                d_albedo, d_power = jax.lax.fori_loop(
                    0, n_batches, body, (d_albedo, d_power)
                )
            # gradient all-reduce over the same photon axis
            return (
                jax.lax.psum(d_albedo, "photons"),
                jax.lax.psum(d_power, "photons"),
            )

        return run(albedo, power, g)

    render.defvjp(render_fwd, render_bwd)
    return jax.jit(render)


def make_autodiff_oracle(
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
):
    """Plain-autodiff twin (scan-based, stores per-batch carries): the
    gradient ORACLE for the replay VJP. Memory-bound — small budgets only."""
    B = int(cfg.photons_per_batch)
    U = uniforms_per_photon(cfg.max_depth)
    schedule = _emitter_batches(np.asarray(emitters.counts), B)
    key = jax.random.PRNGKey(cfg.seed)

    def render(albedo, power):
        lm = jnp.zeros((num_texels, 3), jnp.float32)
        for e, base_batch, n_batches, last_valid in schedule:
            em = schedule_mod.emitter_slice(emitters, e)

            def step(lm, i, em=em, e=e, n_batches=n_batches,
                     last_valid=last_valid, base_batch=base_batch):
                k = jax.random.fold_in(key, base_batch + i)
                u = jax.random.uniform(k, (B, U), dtype=jnp.float32)
                nv = jnp.where(
                    i == n_batches - 1, jnp.int32(last_valid), jnp.int32(B)
                )
                return (
                    trace_batch(lm, rects, em, u, nv, cfg,
                                albedo=albedo, power=power[e]),
                    None,
                )

            lm, _ = jax.lax.scan(step, lm, jnp.arange(n_batches))
        return lm

    return render
