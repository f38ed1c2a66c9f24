"""Monte-Carlo form-factor radiosity engine.

Mirrors performRadiosityNative (/root/reference/radiosityNative.c:92-268):

  1. extend the rect set with windows + lights and append texel ranges for
     them after the wall arena (:104-127)
  2. emissive init: window texels (30,30,30), light texels (28,28,32) (:135-142)
  3. FORM-FACTOR pass: per wall texel, `rays_per_texel` cosine-distributed
     rays from the tile center record the level-0 texel id they hit (:160-227)
  4. 7 GATHER iterations with reflectance 0.3:
         dest[t] = sum_j src[ids[t,j]]
         src     = src*(1-rho) + dest * rho/rays
     followed by a mipmap rebuild of every rect (:230-251)
  5. copy the wall region back (:254-255)

Design (SURVEY.md §2): the form-factor pass is a batched-ray intersection
sweep (threefry uniforms instead of libc rand); the recorded source-id
table — the reference's numTexels x 10000 int32 memory hog (:148-154) —
stays in device memory (3.4 GB on the flagship scene at 10000 rays), and
each gather iteration is a pure gather+sum over it.
"""
from __future__ import annotations

import copy
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RadiosityConfig
from ..ops.device_scene import RectsDev, pack_rects
from ..ops.intersect import nearest_hit
from ..ops.mipmap import build_plan, apply_plan
from ..ops.sampling import TWO_PI_REF, build_base
from ..ops.tile import texel_index
from ..scene.geometry import Scene
from ..scene.rectangle import Rect, num_mipmap_texels, num_tiles
from .ao import tile_centers

f32 = np.float32


def extended_rects(scene: Scene) -> Tuple[List[Rect], int, int, int]:
    """Walls + windows + lights with appended texel ranges
    (radiosityNative.c:104-127). Returns (rects, total_texels,
    first_window_texel, first_light_texel)."""
    rects = [copy.copy(r) for r in scene.walls]
    total = scene.num_texels
    first_window = total
    for r in scene.windows:
        r = copy.copy(r)
        r.base = total
        total += num_mipmap_texels(r)
        rects.append(r)
    first_light = total
    for r in scene.lights:
        r = copy.copy(r)
        r.base = total
        total += num_mipmap_texels(r)
        rects.append(r)
    return rects, total, first_window, first_light


@functools.partial(jax.jit, static_argnames=("rays",))
def _form_factor_chunk(rects: RectsDev, centers, normal, key, rays: int):
    """Hit-texel ids for `rays` cosine rays from each of [C] texel centers.

    Returns [C, rays] int32, -1 where the ray escaped (radiosityNative.c:
    182-223; the reference warns and skips on miss :197-202): _ff_rays
    sampling, then the nearest hit and its texel."""
    C = centers.shape[0]
    src, direc = _ff_rays(centers, normal, key, rays)
    dist, hit = nearest_hit(src, direc, rects)
    p = src + direc * jnp.where(jnp.isfinite(dist), dist, 0.0)[:, None]
    ids = texel_index(rects, hit, p)
    ids = jnp.where(jnp.isfinite(dist), ids, -1)
    return ids.reshape(C, rays).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("rays",))
def _ff_rays(centers, normal, key, rays: int):
    """Cosine-distributed form-factor rays from texel centers: returns
    (origins [C*rays, 3], dirs [C*rays, 3]) — the sampling half of
    _form_factor_chunk."""
    C = centers.shape[0]
    u = jax.random.uniform(key, (C, rays, 2), dtype=jnp.float32)
    r = jnp.sqrt(u[..., 0])
    phi = jnp.float32(TWO_PI_REF) * u[..., 1]
    du = r * jnp.cos(phi)
    dv = r * jnp.sin(phi)
    dn = jnp.sqrt(1.0 - r * r)
    ndir = jnp.broadcast_to(normal, (C, 3))
    udir, vdir = build_base(ndir)
    direc = (
        udir[:, None, :] * du[..., None]
        + vdir[:, None, :] * dv[..., None]
        + ndir[:, None, :] * dn[..., None]
    ).reshape(C * rays, 3)
    src = (centers[:, None, :] + 1e-5 * direc.reshape(C, rays, 3)).reshape(
        C * rays, 3
    )
    return src, direc


def form_factors(
    scene: Scene,
    rects_dev: RectsDev,
    cfg: RadiosityConfig,
) -> np.ndarray:
    """Source-texel-id table [num_wall_texels(level0 span), rays] on host.

    Row t corresponds to arena texel id t; rows for mipmap slots are -1
    (the reference leaves them -1 too, radiosityNative.c:152-153)."""
    rays = int(cfg.rays_per_texel)
    chunk = int(cfg.texels_per_chunk)
    ids = np.full((scene.num_texels, rays), -1, np.int32)
    key = jax.random.PRNGKey(cfg.seed)
    for wi, wall in enumerate(scene.walls):
        centers = tile_centers(wall)
        T = num_tiles(wall)
        normal = jnp.asarray(wall.n)
        for ci, s in enumerate(range(0, T, chunk)):
            c = centers[s : s + chunk]
            n_real = len(c)
            if n_real < chunk:
                c = np.concatenate([c, np.zeros((chunk - n_real, 3), f32)])
            k = jax.random.fold_in(jax.random.fold_in(key, wi), ci)
            out = np.asarray(
                _form_factor_chunk(rects_dev, jnp.asarray(c), normal, k, rays)
            )
            ids[wall.base + s : wall.base + s + n_real] = out[:n_real]
    return ids


@functools.partial(jax.jit, static_argnames=())
def _gather_chunk(src, ids_chunk):
    """dest[t] = sum_j src[ids[t,j]], treating -1 as zero contribution."""
    safe = jnp.maximum(ids_chunk, 0)
    vals = src[safe]  # [C, R, 3]
    mask = (ids_chunk >= 0)[..., None]
    return jnp.sum(jnp.where(mask, vals, 0.0), axis=1)


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_ids(ids, chunk_ids, start):
    return jax.lax.dynamic_update_slice(ids, chunk_ids, (start, 0))


def _ff_schedule(scene: Scene, chunk: int, compact_rows: bool = False):
    """Host-side chunk schedule for the form-factor pass (padded rows of a
    chunk land in later rows of the table; later writes overwrite them, and
    callers exclude trailing junk rows). Returns device arrays
    (centers [C, chunk, 3], normals [C, 3], starts/wis/cis [C]).

    `compact_rows=True` indexes table rows COMPACTLY over level-0 wall
    texels (row = position in the concatenation of the walls' level-0
    ranges) instead of by arena texel id: the arena interleaves ~25%
    mipmap slots that never fire rays, and a compact table skips their
    gather cost and memory entirely (round-4 floor analysis: the gather
    is the radiosity bottleneck and its cost is per-ROW)."""
    centers_all, normals, starts, wis, cis = [], [], [], [], []
    row0 = 0
    for wi, wall in enumerate(scene.walls):
        centers = tile_centers(wall)
        T = num_tiles(wall)
        base = row0 if compact_rows else wall.base
        for ci, s in enumerate(range(0, T, chunk)):
            c = centers[s : s + chunk]
            if len(c) < chunk:
                c = np.concatenate([c, np.zeros((chunk - len(c), 3), f32)])
            centers_all.append(c)
            normals.append(np.asarray(wall.n, f32))
            starts.append(base + s)
            wis.append(wi)
            cis.append(ci)
        row0 += T
    return (
        jnp.asarray(np.stack(centers_all)),
        jnp.asarray(np.stack(normals)),
        jnp.asarray(np.asarray(starts, np.int32)),
        jnp.asarray(np.asarray(wis, np.int32)),
        jnp.asarray(np.asarray(cis, np.int32)),
    )


def _level0_arena_indices(scene: Scene) -> np.ndarray:
    """Arena texel id of each compact row (the scatter map from compact
    gather results back into the full texel arena)."""
    return np.concatenate(
        [
            np.arange(w.base, w.base + num_tiles(w), dtype=np.int64)
            for w in scene.walls
        ]
    )


def _form_factors_device(scene: Scene, rects_dev: RectsDev,
                         cfg: RadiosityConfig, rows_pad: int,
                         compact_rows: bool = False) -> jnp.ndarray:
    """Source-texel-id table as a DEVICE-resident [rows_pad, rays] int32.

    At production scale the table is gigabytes (numTexels x 10k rays, the
    reference's acknowledged memory hog, radiosityNative.c:148-154);
    keeping it on device removes the host round-trip that would otherwise
    stream it out once and back every gather iteration.
    `compact_rows` selects the level-0-compact row layout (_ff_schedule)."""
    rays = int(cfg.rays_per_texel)
    chunk = int(cfg.texels_per_chunk)
    ids = jnp.full((rows_pad, rays), -1, jnp.int32)
    centers_all, normals, starts, wis, cis = _ff_schedule(
        scene, chunk, compact_rows
    )

    key = jax.random.PRNGKey(cfg.seed)
    for i in range(len(cis)):
        k = jax.random.fold_in(
            jax.random.fold_in(key, int(wis[i])), int(cis[i])
        )
        chunk_ids = _form_factor_chunk(
            rects_dev, centers_all[i], normals[i], k, rays
        )
        ids = _write_ids(ids, chunk_ids, int(starts[i]))
    return ids


def render_radiosity_sharded(
    scene: Scene, cfg: RadiosityConfig, mesh=None
) -> np.ndarray:
    """Radiosity with the RAY axis sharded over the `photons` mesh.

    Each device traces rays_per_texel/n_dev decorrelated form-factor rays
    per texel into a LOCAL slice of the source-id table (the reference's
    numTexels x 10000 int32 memory hog, radiosityNative.c:148-154, divides
    across chips), gathers over its slice each iteration, and one psum per
    iteration combines the partial gathers. Same estimator as
    single-device at the same total ray budget (ray partition differs, so
    agreement is statistical — like the sharded photon engines)."""
    import functools as ft

    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import photon_mesh

    shard_map = jax.shard_map
    mesh = mesh or photon_mesh()
    n_dev = mesh.shape["photons"]

    rects, total, first_window, first_light = extended_rects(scene)
    plan = build_plan(rects)

    src = np.zeros((total, 3), f32)
    src[first_window:first_light] = np.asarray(cfg.window_emission, f32)
    src[first_light:total] = np.asarray(cfg.light_emission, f32)

    rho = f32(cfg.reflectance)
    rays_total = int(cfg.rays_per_texel)
    rays_local = (rays_total + n_dev - 1) // n_dev
    rays_eff = rays_local * n_dev  # actual total budget after rounding
    # compact level-0 row space, as in render_radiosity
    l0_total = int(sum(num_tiles(r) for r in scene.walls))
    l0_idx = jnp.asarray(_level0_arena_indices(scene), jnp.int32)
    chunk = max(1, (1 << 22) // max(rays_local, 1))
    n_chunks = (l0_total + chunk - 1) // chunk
    rows_pad = max(
        n_chunks * chunk, l0_total + int(cfg.texels_per_chunk)
    )

    centers_all, normals, starts, wis, cis = _ff_schedule(
        scene, int(cfg.texels_per_chunk), compact_rows=True
    )
    # junk rows: only the trailing [l0_total, rows_pad) slack (the last
    # wall's chunk padding) — masked back to -1 below
    tail_junk = jnp.arange(rows_pad) >= l0_total
    rects_dev = pack_rects(rects)

    repl = P()
    by_rays = P(None, "photons")

    # Pass the schedule arrays as ARGUMENTS (replicated) rather than
    # closing over them: closed-over arrays become XLA constants baked into
    # the executable — duplicated device memory and a fresh compile per
    # scene.
    @ft.partial(
        shard_map, mesh=mesh, in_specs=(repl,) * 7, out_specs=by_rays,
        check_vma=False,
    )
    def build_table(scene_arg, centers_all, normals, starts, wis, cis,
                    tail_junk):
        ax = jax.lax.axis_index("photons")
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), ax)
        ids = jnp.full((rows_pad, rays_local), -1, jnp.int32)

        def body(c, ids):
            k = jax.random.fold_in(jax.random.fold_in(key, wis[c]), cis[c])
            chunk_ids = _form_factor_chunk(
                scene_arg, centers_all[c], normals[c], k, rays_local
            )
            return jax.lax.dynamic_update_slice(
                ids, chunk_ids, (starts[c], 0)
            )

        ids = jax.lax.fori_loop(0, centers_all.shape[0], body, ids)
        return jnp.where(tail_junk[:, None], jnp.int32(-1), ids)

    ids_sharded = jax.jit(build_table)(
        rects_dev,
        jnp.asarray(centers_all), jnp.asarray(normals),
        jnp.asarray(starts), jnp.asarray(wis), jnp.asarray(cis), tail_junk,
    )

    num_texels = scene.num_texels

    def iteration(src_dev, ids):
        @ft.partial(
            shard_map, mesh=mesh, in_specs=(repl, by_rays),
            out_specs=repl, check_vma=False,
        )
        def gather_all(src_dev, ids_local):
            def body(i, dest):
                sl = jax.lax.dynamic_slice(
                    ids_local, (i * chunk, 0), (chunk, rays_local)
                )
                d = _gather_chunk(src_dev, sl)
                return jax.lax.dynamic_update_slice(
                    dest, d, (i * chunk, 0)
                )

            dest = jax.lax.fori_loop(
                0, n_chunks, body, jnp.zeros((rows_pad, 3), jnp.float32)
            )
            return jax.lax.psum(dest, "photons")

        dest = gather_all(src_dev, ids)
        dest_full = (
            jnp.zeros((total, 3), jnp.float32)
            .at[l0_idx]
            .set(dest[:l0_total])
        )
        return src_dev * (1.0 - rho) + dest_full * (rho / rays_eff)

    # one device program for all iterations (one psum per iteration stays).
    # The mipmap rebuild is hoisted OUT of the loop: the gather reads only
    # level-0 ids (the reference records getMipmapTexelId(..., 0),
    # radiosityNative.c:211-217), so per-iteration rebuilds are overwritten
    # unread every iteration — one rebuild after the last relax yields the
    # bit-identical final arena at 1/iterations of the mipmap cost.
    @ft.partial(jax.jit, static_argnames=("iters",))
    def relax(src_dev, ids, iters: int):
        out = jax.lax.fori_loop(
            0, iters, lambda _, s: iteration(s, ids), src_dev
        )
        return apply_plan(out, plan)

    src_dev = relax(jnp.asarray(src), ids_sharded, int(cfg.iterations))

    return np.asarray(src_dev)[:num_texels].copy()


def _radiosity_prep(scene: Scene, cfg: RadiosityConfig):
    """Host prep for render_radiosity: extended rects, mipmap plan,
    emissive init, and the compact gather-table geometry."""
    rects, total, first_window, first_light = extended_rects(scene)
    plan = build_plan(rects)

    # emissive init (radiosityNative.c:135-145)
    src = np.zeros((total, 3), f32)
    src[first_window:first_light] = np.asarray(cfg.window_emission, f32)
    src[first_light:total] = np.asarray(cfg.light_emission, f32)

    rays = int(cfg.rays_per_texel)
    # COMPACT row space: only level-0 wall texels fire rays
    # (radiosityNative.c:170), so the table indexes them contiguously —
    # the arena's ~25% interleaved mipmap slots would otherwise be
    # gathered as masked -1 rows every iteration and pad the table by
    # the same fraction (1.2 GB at the production 10k-ray budget)
    l0_total = int(sum(num_tiles(r) for r in scene.walls))
    l0_idx = jnp.asarray(_level0_arena_indices(scene), jnp.int32)
    chunk = max(1, (1 << 22) // max(rays, 1))  # ~4M gathered ids per step
    n_chunks = (l0_total + chunk - 1) // chunk
    # table must also fit the LAST form-factor chunk's padding in full —
    # dynamic_update_slice clamps out-of-bounds starts, which would shift
    # the write backwards over valid rows
    rows_pad = max(
        n_chunks * chunk, l0_total + int(cfg.texels_per_chunk)
    )
    return (rects, total, plan, src, rays, l0_total, l0_idx, chunk,
            n_chunks, rows_pad)


def _make_relax_impl(cfg, plan, rays, l0_total, l0_idx, chunk, n_chunks,
                     rows_pad, total):
    """Traceable (src_dev, ids, iters) -> final arena: all relaxation
    iterations + one mipmap rebuild.

    ALL relaxation iterations run as one device program (one dispatch).
    The mipmap rebuild is hoisted OUT of the loop: the gather reads only
    LEVEL-0 ids (the reference records getMipmapTexelId(..., 0),
    radiosityNative.c:211-217), so each iteration's rebuild was
    overwritten unread by the next; one rebuild after the last relax
    yields the bit-identical final arena at 1/iterations of the mipmap
    cost."""
    rho = f32(cfg.reflectance)

    def iteration(src_dev, ids):
        def body(i, dest):
            sl = jax.lax.dynamic_slice(ids, (i * chunk, 0), (chunk, rays))
            d = _gather_chunk(src_dev, sl)
            return jax.lax.dynamic_update_slice(dest, d, (i * chunk, 0))

        dest = jax.lax.fori_loop(
            0, n_chunks, body, jnp.zeros((rows_pad, 3), jnp.float32)
        )
        # scatter the compact gather results back into the arena (junk
        # rows beyond l0_total — the last wall's chunk padding — excluded)
        dest_full = (
            jnp.zeros((total, 3), jnp.float32)
            .at[l0_idx]
            .set(dest[:l0_total])
        )
        return src_dev * (1.0 - rho) + dest_full * (rho / rays)

    def relax_impl(src_dev, ids, iters: int):
        out = jax.lax.fori_loop(
            0, iters, lambda _, s: iteration(s, ids), src_dev
        )
        return apply_plan(out, plan)

    return relax_impl


def render_radiosity(scene: Scene, cfg: RadiosityConfig) -> np.ndarray:
    (rects, total, plan, src, rays, l0_total, l0_idx, chunk, n_chunks,
     rows_pad) = _radiosity_prep(scene, cfg)

    ids_dev = _form_factors_device(
        scene, pack_rects(rects), cfg, rows_pad, compact_rows=True
    )
    relax_impl = _make_relax_impl(
        cfg, plan, rays, l0_total, l0_idx, chunk, n_chunks, rows_pad, total
    )
    relax = functools.partial(jax.jit, static_argnames=("iters",))(
        relax_impl
    )
    src_dev = relax(jnp.asarray(src), ids_dev, iters=int(cfg.iterations))
    return np.asarray(src_dev)[: scene.num_texels].copy()
