"""XLA photon engine vs NumPy oracle at shared RNG (SURVEY.md §4: lightmap
comparisons between the device engine and a NumPy oracle at fixed RNG)."""
import dataclasses

import jax
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.engines import photon, photon_oracle_driver, schedule
from flatmatch.engines.oracle import trace_batch_np

pytestmark = pytest.mark.fast
from flatmatch.ops.device_scene import (
    exposure_scale,
    pack_emitters,
    pack_rects,
)
from flatmatch.scene import geometry, image as im, layout
from tests.conftest import FIXTURES

f32 = np.float32


@pytest.fixture(scope="module")
def tiny_scene():
    img = im.load_layout(str(FIXTURES / "tiny.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    return geometry.Scene(lay)


@pytest.fixture(scope="module")
def mini_scene():
    img = im.load_layout(str(FIXTURES / "mini.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    return geometry.Scene(lay)


CFG = PhotonConfig(samples_per_area=3000.0, photons_per_batch=512, seed=7)


def test_single_batch_parity(tiny_scene):
    """One explicit batch of shared uniforms through both implementations."""
    scene = tiny_scene
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    B = 256
    U = photon.uniforms_per_photon(CFG.max_depth)
    uniforms = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(3), (B, U), dtype=np.float32)
    )

    em = photon.EmitterSlice(
        pos=emitters.pos[0],
        wvec=emitters.wvec[0],
        hvec=emitters.hvec[0],
        n=emitters.n[0],
        color=emitters.color[0],
        is_window=emitters.is_window[0],
    )
    lm_xla = np.asarray(
        jax.jit(photon.trace_batch, static_argnames=("cfg",))(
            np.zeros((scene.num_texels, 3), f32),
            rects,
            em,
            uniforms,
            B,
            CFG,
        )
    )
    lm_np = trace_batch_np(
        np.zeros((scene.num_texels, 3), f32),
        rects,
        np.asarray(emitters.pos[0]),
        np.asarray(emitters.wvec[0]),
        np.asarray(emitters.hvec[0]),
        np.asarray(emitters.n[0]),
        np.asarray(emitters.color[0]),
        bool(emitters.is_window[0]),
        uniforms,
        B,
        CFG,
    )
    assert lm_xla.sum() > 0  # photons actually deposited
    # Both paths are float32 with slightly different op orders; near-ties in
    # the nearest-hit argmin can route a photon to a different texel, so
    # allow a tiny fraction of outliers.
    close = np.isclose(lm_xla, lm_np, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} texels match"
    np.testing.assert_allclose(lm_xla.sum(), lm_np.sum(), rtol=1e-4)


def test_full_render_parity(mini_scene):
    """Whole multi-emitter, multi-batch pipeline: XLA vs oracle."""
    scene = mini_scene
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    lm_xla = np.asarray(
        schedule.render_photons(rects, emitters, scene.num_texels, CFG)
    )
    lm_np = photon_oracle_driver.render_photons_np(scene, CFG)
    assert lm_xla.sum() > 0
    close = np.isclose(lm_xla, lm_np, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} texels match"
    np.testing.assert_allclose(lm_xla.sum(), lm_np.sum(), rtol=1e-4)


def test_mipmap_region_untouched(tiny_scene):
    """Photon engines write only level-0 texels (main.c never mipmaps in
    photon modes); exposure_scale zeroes the pyramid slots."""
    scene = tiny_scene
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    lm = np.asarray(schedule.render_photons(rects, emitters, scene.num_texels, CFG))
    scale = exposure_scale(scene, CFG.samples_per_area, CFG.exposure)
    level0 = scene.level0_mask()
    assert (scale[~level0] == 0).all()
    assert (scale[level0] > 0).all()
    out = lm * scale[:, None]
    assert np.isfinite(out).all()
    assert (out >= 0).all()


def test_seed_determinism(tiny_scene):
    scene = tiny_scene
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    a = np.asarray(schedule.render_photons(rects, emitters, scene.num_texels, CFG))
    b = np.asarray(schedule.render_photons(rects, emitters, scene.num_texels, CFG))
    np.testing.assert_array_equal(a, b)
    cfg2 = dataclasses.replace(CFG, seed=CFG.seed + 1)
    c = np.asarray(schedule.render_photons(rects, emitters, scene.num_texels, cfg2))
    assert not np.array_equal(a, c)
