"""Unit tests for the device-side geometry/sampling/addressing ops against
hand-computed values and the reference formulas (SURVEY.md §4: unit tests for
each geometric primitive)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flatmatch.ops import geosphere, mipmap, sampling
from flatmatch.ops.device_scene import RectsDev, pack_rects
from flatmatch.ops.intersect import nearest_hit
from flatmatch.ops.tile import texel_index
from flatmatch.scene.rectangle import create_rect

pytestmark = pytest.mark.fast

f32 = np.float32


def _unit_rect_scene(tile_size=200.0):
    # floor rect at z=0 spanning [0,1]x[0,2]; n = normalized(cross(height,
    # width)) (rectangle.c:22), so width=+y, height=+x gives normal +z
    r = create_rect((0, 0, 0), (0, 1, 0), (2, 0, 0), tile_size)
    r.base = 0
    return pack_rects([r], pad_to=8), r


class TestSampling:
    def test_cosine_ray_unit_and_hemisphere(self):
        key = jax.random.PRNGKey(0)
        u = jax.random.uniform(key, (1000, 2))
        n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (1000, 1))
        d = sampling.cosine_ray(u[:, 0], u[:, 1], n)
        norms = np.linalg.norm(np.asarray(d), axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-5)
        cos = np.asarray(jnp.sum(d * n, -1))
        assert (cos >= -1e-6).all()
        # cosine-weighted: E[cos] = 2/3
        assert abs(cos.mean() - 2 / 3) < 0.02

    def test_sky_ray_quarter_sphere(self):
        """Sky sampler folds the first base coordinate positive
        (photonmap.cl:40-41): for a wall normal +y the base udir is +z after
        orthogonalization, so rays never point below the horizon."""
        key = jax.random.PRNGKey(1)
        u = jax.random.uniform(key, (1000, 2))
        n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (1000, 1))
        d = np.asarray(sampling.sky_ray(u[:, 0], u[:, 1], n))
        # For ndir=+y the orthogonalized base gives udir=(0,0,-1); folding u
        # positive therefore sends every photon downward (z <= 0): sky light
        # travels down into the room, never up from below the horizon.
        assert (d[:, 2] <= 1e-6).all()
        assert (d[:, 1] >= -1e-6).all()  # still in the normal's hemisphere

    def test_build_base_colinear_fallback(self):
        n = jnp.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
        udir, vdir = sampling.build_base(n)
        for arr in (udir, vdir):
            np.testing.assert_allclose(
                np.linalg.norm(np.asarray(arr), axis=-1), 1.0, atol=1e-6
            )
        # orthogonality of the full frame
        np.testing.assert_allclose(np.asarray(jnp.sum(udir * vdir, -1)), 0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jnp.sum(udir * n, -1)), 0, atol=1e-6)


class TestIntersect:
    def test_simple_hit(self):
        rects, _ = _unit_rect_scene()
        src = jnp.array([[0.5, 0.5, 2.0]])
        direc = jnp.array([[0.0, 0.0, -1.0]])
        dist, hit = nearest_hit(src, direc, rects)
        np.testing.assert_allclose(np.asarray(dist), [2.0], rtol=1e-6)
        assert int(hit[0]) == 0

    def test_backface_and_miss(self):
        rects, _ = _unit_rect_scene()
        src = jnp.array(
            [
                [0.5, 0.5, -1.0],  # below the floor: backface
                [5.0, 0.5, 1.0],   # outside the rect bounds
                [0.5, 0.5, 2.0],   # pointing away
            ]
        )
        direc = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
        dist, _ = nearest_hit(src, direc, rects)
        assert np.isinf(np.asarray(dist)).all()

    def test_nearest_of_two(self):
        r1 = create_rect((0, 0, 0), (0, 1, 0), (1, 0, 0), 200.0)  # normal +z
        r2 = create_rect((0, 0, 1), (0, 1, 0), (1, 0, 0), 200.0)  # same facing, higher
        rects = pack_rects([r1, r2], pad_to=8)
        src = jnp.array([[0.5, 0.5, 3.0]])
        direc = jnp.array([[0.0, 0.0, -1.0]])
        dist, hit = nearest_hit(src, direc, rects)
        np.testing.assert_allclose(np.asarray(dist), [2.0], rtol=1e-6)
        assert int(hit[0]) == 1


class TestTexelIndex:
    def test_tile_addressing(self):
        rects, r = _unit_rect_scene(tile_size=4.0)
        # 2m x 1m rect at >=4 texels/m^2: grid doubles to wtiles x htiles
        wt, ht = r.wtiles, r.htiles
        assert wt * ht >= 4.0 * 2.0  # density reached
        p = jnp.array([[0.1, 0.1, 0.0], [1.9, 0.9, 0.0]])
        hit = jnp.zeros(2, jnp.int32)
        idx = np.asarray(texel_index(rects, hit, p))
        assert idx[0] == 0
        assert idx[1] == wt * ht - 1

    def test_clamping(self):
        rects, r = _unit_rect_scene(tile_size=4.0)
        p = jnp.array([[-0.5, -0.5, 0.0], [2.5, 1.5, 0.0]])
        hit = jnp.zeros(2, jnp.int32)
        idx = np.asarray(texel_index(rects, hit, p))
        assert idx[0] == 0
        assert idx[1] == r.wtiles * r.htiles - 1


class TestGeosphere:
    @pytest.mark.parametrize(
        "depth,count", [(2, 19), (3, 113), (4, 481), (5, 1985)]
    )
    def test_counts(self, depth, count):
        """Vector counts match the reference tables (geoSphere.h:15-25)."""
        vs = geosphere.geosphere(depth)
        assert len(vs) == count
        np.testing.assert_allclose(np.linalg.norm(vs, axis=-1), 1.0, atol=1e-6)
        assert (vs[:, 2] > 0).all()


def _reference_mipmap_np(texels, r):
    """Direct recursive port of mipmapInternal (rectangle.c:535-569) used as
    the oracle for the vectorized plan."""
    def horiz(base, width):
        if width == 1:
            return
        tw = width // 2
        for i in range(tw):
            texels[base + width + i] = (
                texels[base + 2 * i] + texels[base + 2 * i + 1]
            ) * f32(0.5)
        horiz(base + width, tw)

    def inner(base, w, h):
        if w == 1 and h == 1:
            return
        if h == 1:
            return horiz(base, w)
        if w == 1:
            return horiz(base, h)
        tw, th = w // 2, h // 2
        for i in range(tw):
            for j in range(th):
                texels[base + w * h + j * tw + i] = (
                    texels[base + (2 * j) * w + 2 * i]
                    + texels[base + (2 * j + 1) * w + 2 * i]
                    + texels[base + (2 * j) * w + 2 * i + 1]
                    + texels[base + (2 * j + 1) * w + 2 * i + 1]
                ) * f32(0.25)
        inner(base + w * h, tw, th)

    inner(r.base, r.wtiles, r.htiles)
    return texels


class TestMipmap:
    @pytest.mark.parametrize("dims", [(4, 4), (8, 2), (1, 8), (16, 1), (2, 8)])
    def test_plan_matches_reference_recursion(self, dims):
        w, h = dims
        r = create_rect((0, 0, 0), (w / 10, 0, 0), (0, h / 10, 0), 1.0)
        r.wtiles, r.htiles = w, h
        r.base = 3  # nonzero arena offset
        from flatmatch.scene.rectangle import num_mipmap_texels

        total = r.base + num_mipmap_texels(r)
        rng = np.random.default_rng(0)
        texels = rng.random((total, 3)).astype(f32)

        plan = mipmap.build_plan([r])
        ours = mipmap.apply_plan_np(texels.copy(), plan)
        ref = _reference_mipmap_np(texels.copy(), r)
        np.testing.assert_allclose(ours, ref, rtol=1e-6)

        ours_dev = np.asarray(mipmap.apply_plan(jnp.asarray(texels), plan))
        np.testing.assert_allclose(ours_dev, ref, rtol=1e-6)
