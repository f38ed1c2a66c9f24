"""Photon trace kernel for NVIDIA GPUs: Pallas through Triton.

The design is the reference's own OpenCL kernel (photonmap.cl:161-281): one
thread per photon, the whole 8-bounce path in registers, a brute-force loop
over every rect, and a deposit per bounce. One Triton program traces a block
of `block` photons (a power of two); its threads loop over the rects with
every rect field read as a scalar from a small [F, N] array that stays in L1.
The deposits leave the kernel as a [D, B] texel-id stream plus [3, D, B]
colors and are binned by XLA's scatter-add (native atomics on the GPU), the
same scatter the XLA engine uses in place of the reference's racy
`lightColors[idx] += color` (photonmap.cl:256-258).

Rects are grouped by normal axis (ops/aa_scene.py), so the per-rect test is
the axis-aligned form: one multiply by the hoisted reciprocal direction for
the plane distance plus two interval checks. After the loop, the winning
rect's distance is recomputed with the general form's exact division and
its texel addressed exactly as ops/tile.texel_index does, so the kernel and
engines/photon.trace_batch agree photon by photon on the same uniforms
(interpret mode, tests/test_photon_kernel.py). On the card Triton's
transcendentals and fused multiply-adds differ from XLA's in the last bits
and paths decorrelate; parity there is statistical.

Blocks whose first photon is past `n_valid` (the masked tail of an emitter's
last batch) skip the trace and write empty deposits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import PhotonConfig
from ..ops.aa_scene import (
    A_CU, A_CV, A_HLEN, A_HS, A_HT, A_O, A_SN, A_WLEN, A_WS, A_WT, F_AA,
    GROUP_UV, AARectsDev,
)
from ..ops.sampling import TWO_PI_REF
from ..ops.splat import scatter_splat
from .photon import DEAD, EmitterSlice, uniforms_per_photon


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static launch parameters of the trace kernel.

    `block` photons per Triton program (a power of two) and `num_warps`
    come from a sweep on the card (PERF.md). `interpret=True` runs the
    kernel in the Pallas interpreter on any backend; only tests set it."""

    group_counts: Tuple[int, int, int]
    block: int = 256
    num_warps: int = 2
    interpret: bool = False


def emitter_vector(em: EmitterSlice) -> jnp.ndarray:
    """[16] f32: pos, wvec, hvec, n, color, is_window flag."""
    return jnp.concatenate(
        [
            em.pos, em.wvec, em.hvec, em.n, em.color,
            jnp.where(em.is_window, 1.0, 0.0)[None].astype(jnp.float32),
        ]
    )


def _normalize(x, y, z):
    """normalize3 (ops/linalg.py): reciprocal length, left-to-right sum."""
    fac = 1.0 / jnp.sqrt(x * x + y * y + z * z)
    return x * fac, y * fac, z * fac


def _build_base(nx, ny, nz):
    """ops/sampling.build_base on components (photonmap.cl:43-48)."""
    colinear = jnp.abs(nz) >= 0.999999
    zero = jnp.zeros_like(nx)
    one = jnp.ones_like(nx)
    ux, uy, uz = zero, jnp.where(colinear, one, zero), jnp.where(
        colinear, zero, one
    )
    vx, vy, vz = _normalize(
        uy * nz - uz * ny, uz * nx - ux * nz, ux * ny - uy * nx
    )
    ux, uy, uz = _normalize(
        vy * nz - vz * ny, vz * nx - vx * nz, vx * ny - vy * nx
    )
    return (ux, uy, uz), (vx, vy, vz)


def _hash_draw(seed, gid, c):
    """Counter-hash uniform in [0, 1): murmur3's fmix32 finalizer over
    (photon id, draw column, batch seed), top 24 bits — the analog of the
    reference kernel's per-item LCG (photonmap.cl:21-25, :272-275), but
    order-independent."""
    x = _fmix32(gid * jnp.int32(-1640531527) + (seed + c * jnp.int32(97929)))
    return jax.lax.shift_right_logical(x, 8).astype(jnp.float32) * (
        jnp.float32(1.0 / (1 << 24))
    )


def _fmix32(x):
    """murmur3 finalizer on int32 (wrapping) arithmetic."""
    x = x ^ jax.lax.shift_right_logical(x, 16)
    x = x * jnp.int32(-2048144789)   # 0x85ebca6b
    x = x ^ jax.lax.shift_right_logical(x, 13)
    x = x * jnp.int32(-1028477387)   # 0xc2b2ae35
    return x ^ jax.lax.shift_right_logical(x, 16)


def batch_seed(seed: int, global_batch):
    """int32 device-RNG seed per (run seed, global batch index)."""
    return (
        jnp.int32(seed) * jnp.int32(1000003)
        + jnp.asarray(global_batch, jnp.int32)
    )


def device_seed(seed, ax):
    """Decorrelate a batch seed per mesh device with a full avalanche. An
    additive offset is not safe: the counter hash starts from
    `gid * C + seed`, so any `seed + ax * C` scheme makes device ax's photon
    g draw the exact uniforms of device 0's photon g + ax."""
    return _fmix32(
        jnp.asarray(seed, jnp.int32)
        + (jnp.asarray(ax, jnp.int32) + jnp.int32(1))
        * jnp.int32(-2048144789)
    )


def _make_kernel(cfg: PhotonConfig, spec: KernelSpec, hash_rng: bool):
    D = cfg.max_depth
    TB = spec.block
    eps = np.float32(cfg.self_intersect_eps)
    two_pi = np.float32(TWO_PI_REF)
    rr = np.float32(cfg.rr_mirror_prob)
    mirror_z = np.float32(cfg.mirror_z_threshold)
    tint_z = np.float32(cfg.floor_tint_z_threshold)
    tint = tuple(np.float32(t) for t in cfg.floor_tint)
    albedo = np.float32(cfg.albedo)
    group_counts = tuple(spec.group_counts)
    g0, g1, _ = group_counts
    starts = (0, g0, g0 + g1)
    inf = np.float32(np.inf)

    def nearest(f_ref, pos, direc):
        """Kernel slot of the nearest front-face hit, or -1: the
        axis-aligned test over every rect."""
        best = jnp.full((TB,), inf, jnp.float32)
        bj = jnp.full((TB,), -1, jnp.int32)
        for a in range(3):
            if group_counts[a] == 0:
                continue
            au, av = GROUP_UV[a]
            pa, da = pos[a], direc[a]
            ia = 1.0 / da  # div-by-zero -> inf, rejected by the front test
            pu, du = pos[au], direc[au]
            pv, dv = pos[av], direc[av]

            def one_rect(j, carry, pa=pa, da=da, ia=ia, pu=pu, du=du,
                         pv=pv, dv=dv):
                best, bj = carry
                fac = (f_ref[A_O, j] - pa) * ia
                u = (pu + du * fac - f_ref[A_CU, j]) * f_ref[A_WS, j]
                v = (pv + dv * fac - f_ref[A_CV, j]) * f_ref[A_HS, j]
                # front face (denom < 0) & fac >= 0 & u in [0, wlen]
                # & v in [0, hlen]; NaN fails the >= like the compares
                ok = (da * f_ref[A_SN, j] < 0) & (
                    jnp.minimum(
                        jnp.minimum(fac, u),
                        jnp.minimum(
                            f_ref[A_WLEN, j] - u,
                            jnp.minimum(v, f_ref[A_HLEN, j] - v),
                        ),
                    )
                    >= 0
                )
                upd = ok & (fac < best)
                return jnp.where(upd, fac, best), jnp.where(upd, j, bj)

            best, bj = jax.lax.fori_loop(
                starts[a], starts[a] + group_counts[a], one_rect, (best, bj)
            )
        return bj

    def trace(em_ref, f_ref, base_ref, src_ref, idx_ref, col_ref, start,
              alive):
        cols = pl.ds(start, TB)
        if hash_rng:
            seed = src_ref[0]
            gid = start + jnp.arange(TB, dtype=jnp.int32)

            def draw(c):
                return _hash_draw(seed, gid, c)
        else:
            def draw(c):
                return src_ref[c, cols]

        em = [em_ref[k] for k in range(16)]
        epos, ew, eh, en, ecol = (
            em[0:3], em[3:6], em[6:9], em[9:12], em[12:15]
        )

        # --- emission (photonmap.cl:173-181; engines/photon.emit) --------
        dx, dy = draw(0), draw(1)
        r = jnp.sqrt(draw(2))
        phi = two_pi * draw(3)
        u = r * jnp.cos(phi)
        v = r * jnp.sin(phi)
        nz = jnp.sqrt(1.0 - r * r)
        u = jnp.where(em[15] > 0, jnp.abs(u), u)
        ones = jnp.ones((TB,), jnp.float32)
        n = tuple(c * ones for c in en)
        ud, vd = _build_base(*n)
        direc = tuple(ud[k] * u + vd[k] * v + n[k] * nz for k in range(3))
        pos = tuple(
            epos[k] + ew[k] * dx + eh[k] * dy + direc[k] * eps
            for k in range(3)
        )
        color = tuple(c * ones for c in ecol)

        def bounce(d, state):
            pos, direc, color, alive = state
            bj = nearest(f_ref, pos, direc)
            hit = bj >= 0
            alive = alive & hit
            j = jnp.maximum(bj, 0)

            def field(row):
                return plgpu.load(f_ref.at[row, j])

            sn, o = field(A_SN), field(A_O)
            axis = (j >= starts[1]).astype(jnp.int32) + (
                j >= starts[2]
            ).astype(jnp.int32)
            ax0, ax2 = axis == 0, axis == 2
            pa = jnp.where(ax0, pos[0], jnp.where(ax2, pos[2], pos[1]))
            da = jnp.where(ax0, direc[0], jnp.where(ax2, direc[2], direc[1]))
            # the general form's exact distance (ops/intersect.py): with
            # n = sn * e_axis every dot product is a single product
            dist = jnp.where(hit, (sn * o - pa * sn) / (da * sn), 0.0)
            pos = tuple(pos[k] + direc[k] * dist for k in range(3))

            # texel addressing (ops/tile.texel_index)
            pu = jnp.where(ax0, pos[1], pos[0])
            pv = jnp.where(ax2, pos[1], pos[2])
            wt, ht = field(A_WT), field(A_HT)
            wti, hti = wt.astype(jnp.int32), ht.astype(jnp.int32)
            ddx = field(A_WS) * (pu - field(A_CU))
            ddy = field(A_HS) * (pv - field(A_CV))
            tx = jnp.clip(
                (ddx * wt / field(A_WLEN)).astype(jnp.int32), 0, wti - 1
            )
            ty = jnp.clip(
                (ddy * ht / field(A_HLEN)).astype(jnp.int32), 0, hti - 1
            )
            texel = plgpu.load(base_ref.at[j]) + ty * wti + tx
            hn = tuple(jnp.where(axis == k, sn, 0.0) for k in range(3))

            # --- Russian roulette + bounce (photonmap.cl:236-254) --------
            u_rr = draw(4 + 3 * d)
            u1 = draw(5 + 3 * d)
            u2 = draw(6 + 3 * d)
            diffuse = (pos[2] > mirror_z) | (u_rr > rr)
            r = jnp.sqrt(u1)
            phi = two_pi * u2
            du = r * jnp.cos(phi)
            dv = r * jnp.sin(phi)
            dn = jnp.sqrt(1.0 - r * r)
            bu, bv = _build_base(*hn)
            ddiff = [bu[k] * du + bv[k] * dv + hn[k] * dn for k in range(3)]
            ndotd = hn[0] * direc[0] + hn[1] * direc[1] + hn[2] * direc[2]
            dmir = [direc[k] - 2.0 * ndotd * hn[k] for k in range(3)]
            on_floor = pos[2] < tint_z
            color = tuple(
                jnp.where(
                    diffuse,
                    color[k] * jnp.where(on_floor, tint[k], 1.0) * albedo,
                    color[k],
                )
                for k in range(3)
            )
            direc = tuple(
                jnp.where(diffuse, ddiff[k], dmir[k]) for k in range(3)
            )

            # --- deposit (photonmap.cl:256-258) --------------------------
            idx_ref[d, cols] = jnp.where(alive, texel, DEAD)
            for k in range(3):
                col_ref[k, d, cols] = jnp.where(alive, color[k], 0.0)
            pos = tuple(pos[k] + direc[k] * eps for k in range(3))
            return pos, direc, color, alive

        # a loop, not an unrolled body: the same speed on the card and a
        # tenth of the compile time (PERF.md)
        jax.lax.fori_loop(0, D, bounce, (pos, direc, color, alive))

    def kernel(em_ref, nv_ref, f_ref, base_ref, src_ref, idx_ref, col_ref):
        start = pl.program_id(0) * TB
        n_valid = nv_ref[0]

        @pl.when(start < n_valid)
        def _():
            alive = start + jnp.arange(TB, dtype=jnp.int32) < n_valid
            trace(em_ref, f_ref, base_ref, src_ref, idx_ref, col_ref, start,
                  alive)

        @pl.when(start >= n_valid)
        def _():
            cols = pl.ds(start, TB)
            for d in range(D):
                idx_ref[d, cols] = jnp.full((TB,), DEAD, jnp.int32)
                for k in range(3):
                    col_ref[k, d, cols] = jnp.zeros((TB,), jnp.float32)

    return kernel


def _launch(fields, base, em_vec, src, n_valid, B, cfg, spec, hash_rng):
    if fields.shape[0] != F_AA:
        raise ValueError(f"fields must be [{F_AA}, N], got {fields.shape}")
    TB = int(spec.block)
    if TB < 1 or TB & (TB - 1):
        raise ValueError(f"block must be a power of two, got {TB}")
    n_blocks = -(-B // TB)
    Bp = n_blocks * TB
    if not hash_rng and Bp != B:
        src = jnp.pad(src, ((0, 0), (0, Bp - B)))
    D = cfg.max_depth
    idx, col = pl.pallas_call(
        _make_kernel(cfg, spec, hash_rng),
        out_shape=(
            jax.ShapeDtypeStruct((D, Bp), jnp.int32),
            jax.ShapeDtypeStruct((3, D, Bp), jnp.float32),
        ),
        grid=(n_blocks,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=int(spec.num_warps)),
        interpret=spec.interpret,
        name="photon_trace",
    )(
        em_vec, jnp.reshape(jnp.asarray(n_valid, jnp.int32), (1,)),
        fields, base, src,
    )
    return idx[:, :B], col[:, :, :B]


@functools.partial(jax.jit, static_argnames=("cfg", "spec"))
def trace_deposits(
    fields, base, em_vec, uniforms, n_valid, cfg: PhotonConfig,
    spec: KernelSpec,
):
    """Trace one batch: returns (texel ids [D, B] int32, colors [3, D, B]).

    `uniforms` is the [B, U] draw layout shared with engines/photon and the
    NumPy oracle. A batch that is not a multiple of `spec.block` is padded
    with masked photons. Dead photons deposit id DEAD with zero color."""
    B, U = uniforms.shape
    if U != uniforms_per_photon(cfg.max_depth):
        raise ValueError(
            f"uniforms must have {uniforms_per_photon(cfg.max_depth)} "
            f"columns, got {U}"
        )
    return _launch(fields, base, em_vec, uniforms.T, n_valid, B, cfg, spec,
                   hash_rng=False)


@functools.partial(
    jax.jit, static_argnames=("batch_size", "cfg", "spec")
)
def trace_deposits_rng(
    fields, base, em_vec, seed, n_valid, batch_size: int,
    cfg: PhotonConfig, spec: KernelSpec,
):
    """trace_deposits with the in-kernel counter-hash RNG (cfg.device_rng):
    no uniforms tensor. `seed` is an int32 unique per (batch[, device])."""
    return _launch(
        fields, base, em_vec, jnp.reshape(jnp.asarray(seed, jnp.int32), (1,)),
        n_valid, int(batch_size), cfg, spec, hash_rng=True,
    )


def trace_batch_kernel(
    lightmap, aa: AARectsDev, em: EmitterSlice, uniforms, n_valid,
    cfg: PhotonConfig, spec: KernelSpec,
):
    """engines/photon.trace_batch on the kernel: same draws, same deposits."""
    from ..backend import require_kernel_backend

    require_kernel_backend(spec.interpret)
    idx, col = trace_deposits(
        aa.fields, aa.base, emitter_vector(em), uniforms, n_valid, cfg, spec
    )
    return scatter_splat(lightmap, idx, col)
