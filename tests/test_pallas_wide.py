"""The photon trace kernel (engines/photon_triton.py, the photon_pallas
engine) against the XLA engine, in the Pallas interpreter on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.engines import photon, photon_triton as pt, schedule
from flatmatch.engines.schedule import emitter_slice
from flatmatch.ops.aa_scene import pack_aa
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.scene.rect_dump import load_rect_dump
from flatmatch.scene.rectangle import create_rect, num_tiles
from tests.conftest import FIXTURES

CFG = PhotonConfig(samples_per_area=2000.0, photons_per_batch=512, seed=9)


def spec(aa, block=64, warps=1):
    return pt.KernelSpec(aa.group_counts, block=block, num_warps=warps,
                         interpret=True)


@pytest.fixture(scope="module")
def tiny():
    scene = load_rect_dump(FIXTURES / "tiny_rects.txt")
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    return scene, rects, emitters


def _uniforms(key, B, cfg=CFG):
    return jax.random.uniform(
        jax.random.PRNGKey(key), (B, photon.uniforms_per_photon(cfg.max_depth)),
        dtype=jnp.float32,
    )


def test_device_rng_matches_statistically(tiny):
    """The in-kernel counter-hash RNG (cfg.device_rng) targets the same
    integral as the threefry draws: total and per-wall energies agree to
    MC tolerance, and the run is deterministic. The streams differ by
    design — exactly the reference's CL-LCG vs native-rand() pair."""
    scene, rects, _ = tiny
    aa = pack_aa(scene.walls)
    base = dataclasses.replace(CFG, samples_per_area=30000.0,
                               photons_per_batch=1024)
    ems = pack_emitters(scene, base.samples_per_area, base.window_color,
                        base.light_color)
    cfg_rng = dataclasses.replace(base, device_rng=True)

    def run(cfg):
        return np.asarray(schedule.render_photons(
            rects, ems, scene.num_texels, cfg, kernel=spec(aa), aa=aa))

    a, b, b2 = run(base), run(cfg_rng), run(cfg_rng)
    np.testing.assert_array_equal(b, b2)
    np.testing.assert_allclose(b.sum(), a.sum(), rtol=0.03)
    for r in scene.walls:
        s = b[r.base : r.base + num_tiles(r)].sum()
        t = a[r.base : r.base + num_tiles(r)].sum()
        if t > a.sum() * 0.01:
            np.testing.assert_allclose(s, t, rtol=0.2)


def test_pack_aa_accepts_layout_scenes(tiny):
    scene, rects, emitters = tiny
    aa = pack_aa(scene.walls)
    assert aa is not None
    assert sum(aa.group_counts) == len(scene.walls)
    assert aa.fields.shape[1] == len(scene.walls)
    assert sorted(np.asarray(aa.base)) == sorted(r.base for r in scene.walls)


def test_pack_aa_rejects_tilted_rect():
    r = create_rect((0, 0, 0), (1, 1, 0), (0, 0, 1), 200.0)  # 45-degree wall
    assert pack_aa([r]) is None


@pytest.mark.fast
def test_wide_matches_xla_batch(tiny):
    """Same draws, same deposits: the kernel's lightmap equals
    engines/photon.trace_batch's bit for bit."""
    scene, rects, emitters = tiny
    aa = pack_aa(scene.walls)
    B = 1024
    uniforms = _uniforms(4, B)
    em = emitter_slice(emitters, 0)
    lm0 = jnp.zeros((scene.num_texels, 3), jnp.float32)
    lm_xla = np.asarray(
        jax.jit(photon.trace_batch, static_argnames=("cfg",))(
            lm0, rects, em, uniforms, B, CFG
        )
    )
    lm_kernel = np.asarray(
        pt.trace_batch_kernel(lm0, aa, em, uniforms, B, CFG, spec(aa))
    )
    assert lm_kernel.sum() > 0
    np.testing.assert_array_equal(lm_kernel, lm_xla)


def test_wide_masks_invalid_photons(tiny):
    scene, rects, emitters = tiny
    aa = pack_aa(scene.walls)
    B = 512
    uniforms = _uniforms(5, B)
    em = emitter_slice(emitters, 0)
    lm0 = jnp.zeros((scene.num_texels, 3), jnp.float32)

    def run(n_valid):
        return np.asarray(pt.trace_batch_kernel(
            lm0, aa, em, uniforms, n_valid, CFG, spec(aa)))

    half, full = run(256), run(512)
    assert 0 < half.sum() < full.sum()
    lm_xla_half = np.asarray(
        jax.jit(photon.trace_batch, static_argnames=("cfg",))(
            lm0, rects, em, uniforms, 256, CFG
        )
    )
    np.testing.assert_array_equal(half, lm_xla_half)


@pytest.mark.parametrize("rng", ["threefry", "device_rng"])
def test_tail_shrink_bit_identical(tiny, rng):
    """Blocks past n_valid (an emitter's masked tail) skip the trace and
    deposit nothing; the live photons' deposits do not depend on how many
    dead blocks follow them: a batch launched at its full size equals
    the same photons launched on a shrunk grid."""
    scene, rects, emitters = tiny
    aa = pack_aa(scene.walls)
    ev = pt.emitter_vector(emitter_slice(emitters, 0))
    B, n_valid, B_small = 1024, 200, 256
    if rng == "threefry":
        u = _uniforms(6, B)
        full = pt.trace_deposits(aa.fields, aa.base, ev, u, n_valid, CFG,
                                 spec(aa))
        small = pt.trace_deposits(aa.fields, aa.base, ev, u[:B_small],
                                  n_valid, CFG, spec(aa))
    else:
        full = pt.trace_deposits_rng(aa.fields, aa.base, ev, 77, n_valid, B,
                                     CFG, spec(aa))
        small = pt.trace_deposits_rng(aa.fields, aa.base, ev, 77, n_valid,
                                      B_small, CFG, spec(aa))
    (fi, fc), (si, sc) = [tuple(map(np.asarray, x)) for x in (full, small)]
    np.testing.assert_array_equal(fi[:, :B_small], si)
    np.testing.assert_array_equal(fc[:, :, :B_small], sc)
    assert (fi[:, n_valid:] == photon.DEAD).all()
    assert (fc[:, :, n_valid:] == 0).all()
    assert (fi[:, :n_valid] != photon.DEAD).any()


def test_device_rng_sharded_decorrelation(tiny):
    """Per-device RNG seeds must be avalanche-mixed: the counter hash
    starts from gid*C + seed, so an additive seed + ax*C scheme makes
    device ax's photon g draw the EXACT uniforms of device 0's photon g+ax
    (shifted-copy streams, no variance reduction from the mesh).
    device_seed destroys that structure."""
    scene, rects, emitters = tiny
    aa = pack_aa(scene.walls)
    B = 512
    C = -1640531527
    ev = pt.emitter_vector(emitter_slice(emitters, 0))
    base = pt.batch_seed(CFG.seed, 0)

    def run(seed):
        # deposit streams -> [B, D, 4] rows of (texel id, r, g, b) per
        # photon; the texel id breaks ties between photons whose colors
        # coincide (colors take a small discrete set of values)
        idx, col = pt.trace_deposits_rng(aa.fields, aa.base, ev, seed, B, B,
                                         CFG, spec(aa))
        idx = np.asarray(idx).T[..., None].astype(np.float64)
        col = np.asarray(col).transpose(2, 1, 0)
        return np.concatenate([idx, col], axis=2)

    a_old, b_old = run(base), run(base + np.int32(C))
    a_new, b_new = run(pt.device_seed(base, 0)), run(pt.device_seed(base, 1))
    # the additive scheme's device-1 photon g IS device-0 photon g+1
    np.testing.assert_array_equal(b_old[:-1], a_old[1:])
    live_rows = lambda x: np.any(x[..., 1:] != 0, axis=(1, 2))  # noqa: E731
    for shift in range(4):
        a = a_new[shift:] if shift else a_new
        b = b_new[: B - shift]
        live = live_rows(a) & live_rows(b)
        same = np.all(a == b, axis=(1, 2)) & live
        assert same.sum() <= max(1, 0.01 * live.sum()), (shift, same.sum())
