"""Radiosity engine: structure, gather math, determinism, physics sanity."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from flatmatch.config import RadiosityConfig
from flatmatch.engines import radiosity
from flatmatch.ops.device_scene import pack_rects
from flatmatch.ops.mipmap import apply_plan_np, build_plan
from flatmatch.scene import geometry, image as im, layout
from flatmatch.scene.rectangle import num_mipmap_texels, num_tiles
from tests.conftest import FIXTURES

f32 = np.float32

CFG = RadiosityConfig(rays_per_texel=128, seed=3, texels_per_chunk=256)


@pytest.fixture(scope="module")
def mini():
    img = im.load_layout(str(FIXTURES / "mini.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    return geometry.Scene(lay)


def test_extended_rects_layout(mini):
    """Window/light texel ranges append after the wall arena
    (radiosityNative.c:104-127)."""
    rects, total, first_window, first_light = radiosity.extended_rects(mini)
    assert len(rects) == len(mini.walls) + len(mini.windows) + len(mini.lights)
    assert first_window == mini.num_texels
    expect = mini.num_texels + sum(num_mipmap_texels(r) for r in mini.windows)
    assert first_light == expect
    assert total == expect + sum(num_mipmap_texels(r) for r in mini.lights)
    # contiguous, non-overlapping bases
    cur = mini.num_texels
    for r in rects[len(mini.walls) :]:
        assert r.base == cur
        cur += num_mipmap_texels(r)
    # originals must not be mutated
    assert all(r.base == 0 for r in mini.windows + mini.lights)


def test_form_factor_ids_in_range(mini):
    rects, total, _, _ = radiosity.extended_rects(mini)
    ids = radiosity.form_factors(mini, pack_rects(rects), CFG)
    assert ids.shape == (mini.num_texels, CFG.rays_per_texel)
    assert ids.max() < total
    assert ids.min() >= -1
    level0 = mini.level0_mask()
    # mipmap rows stay -1 (no rays fired from pyramid slots)
    assert (ids[~level0] == -1).all()
    # interior texels almost always hit something (closed room)
    hit_frac = (ids[level0] >= 0).mean()
    assert hit_frac > 0.95, hit_frac


def test_gather_chunk_matches_numpy(mini):
    rng = np.random.default_rng(0)
    T, R = 50, 16
    src = rng.random((64, 3)).astype(f32)
    ids = rng.integers(-1, 64, size=(T, R)).astype(np.int32)
    ours = np.asarray(radiosity._gather_chunk(jnp.asarray(src), jnp.asarray(ids)))
    expect = np.zeros((T, 3), f32)
    for t in range(T):
        for j in range(R):
            if ids[t, j] >= 0:
                expect[t] += src[ids[t, j]]
    np.testing.assert_allclose(ours, expect, rtol=1e-5)


def test_render_radiosity_end_to_end(mini):
    out = radiosity.render_radiosity(mini, CFG)
    assert out.shape == (mini.num_texels, 3)
    assert np.isfinite(out).all()
    assert (out >= 0).all()
    assert out.sum() > 0
    # determinism at fixed seed
    out2 = radiosity.render_radiosity(mini, CFG)
    np.testing.assert_array_equal(out, out2)
    # walls visible from the window must be brighter than the global floor
    lit = out.max()
    assert lit > 0.1
    # mipmap consistency: pyramid slots equal the plan applied to level 0
    rects, total, fw, fl = radiosity.extended_rects(mini)
    plan = build_plan(mini.walls)
    re_mipped = apply_plan_np(out.copy(), plan)
    np.testing.assert_allclose(re_mipped, out, rtol=1e-5, atol=1e-6)


def test_iterations_propagate_light(mini):
    """With reflectance 0.3 more iterations move more energy onto walls."""
    one = radiosity.render_radiosity(
        mini, dataclasses.replace(CFG, iterations=1)
    )
    seven = radiosity.render_radiosity(
        mini, dataclasses.replace(CFG, iterations=7)
    )
    assert seven.sum() > one.sum()


def test_form_factors_device_batch_matches_np(mini):
    """The device-resident form-factor table (the one the engine gathers
    from) vs the per-chunk host table at identical keys."""
    small = dataclasses.replace(
        CFG, rays_per_texel=32, texels_per_chunk=128
    )
    rects, total, _, _ = radiosity.extended_rects(mini)
    rects_dev = pack_rects(rects)
    ids_np = radiosity.form_factors(mini, rects_dev, small)
    rows_pad = mini.num_texels + small.texels_per_chunk
    ids_dev = np.asarray(
        radiosity._form_factors_device(mini, rects_dev, small, rows_pad)
    )
    level0 = mini.level0_mask()
    np.testing.assert_array_equal(
        ids_dev[: mini.num_texels][level0], ids_np[level0]
    )
