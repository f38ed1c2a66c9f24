"""Property-based fuzzing of the ENGINES (round-4 VERDICT #5).

test_fuzz_scene.py checks that random layouts *compile* soundly; these
tests check that the compiled scenes *trace identically* on the photon
trace kernel (engines/photon_triton.py, interpret mode) and the XLA engine
when both consume the same uniform draws — covering the AA grouping and
packing edge cases (group order, empty groups, texel clamping at rect
borders) that hand fixtures can't enumerate. Anchor: the reference's brute-force
kernel loop (/root/reference/photonmap.cl:194-206) — the path with no
tree to hide behind, where every rect/axis edge case lands.

Degenerate layouts get dedicated cases: a room 1-2 px from the image
edge, a window flush in a room corner, and a hand-built scene whose AA
grouping has a ZERO-count normal axis (no y-facing rects at all).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from flatmatch.config import PhotonConfig
from flatmatch.engines import photon, photon_triton
from flatmatch.ops.aa_scene import pack_aa
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.scene import geometry, image as im, layout
from tests.test_fuzz_scene import (
    EMPTY, OUTSIDE, WALL, WINDOW, _random_layout,
)

f32 = np.float32

CFG = PhotonConfig(samples_per_area=2000.0, photons_per_batch=512, seed=3)
B = 512


def _kernel_batch(lm0, aa, em, uniforms):
    return np.asarray(photon_triton.trace_batch_kernel(
        lm0, aa, em, uniforms, B, CFG,
        photon_triton.KernelSpec(aa.group_counts, block=128, interpret=True),
    ))


def _emitter_slice(emitters, e):
    return photon.EmitterSlice(
        pos=emitters.pos[e],
        wvec=emitters.wvec[e],
        hvec=emitters.hvec[e],
        n=emitters.n[e],
        color=emitters.color[e],
        is_window=emitters.is_window[e],
    )


def _assert_wide_matches_xla(scene, emitter_ids=None, uniforms_key=4):
    """One shared-draws batch per selected emitter: the trace kernel
    (interpret mode) must reproduce the XLA engine draws-for-draws, up to
    knife-edge ties between rects at equal distance."""
    rects = pack_rects(scene.walls)
    aa = pack_aa(scene.walls)
    assert aa is not None
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    n_em = int(emitters.pos.shape[0])
    assert n_em >= 1
    if emitter_ids is None:
        emitter_ids = sorted({0, n_em - 1})
    U = photon.uniforms_per_photon(CFG.max_depth)
    uniforms = jax.random.uniform(
        jax.random.PRNGKey(uniforms_key), (B, U), dtype=np.float32
    )
    lm0 = jnp.zeros((scene.num_texels, 3), jnp.float32)
    for e in emitter_ids:
        em = _emitter_slice(emitters, e)
        lm_xla = np.asarray(
            jax.jit(photon.trace_batch, static_argnames=("cfg",))(
                lm0, rects, em, uniforms, B, CFG
            )
        )
        lm_wide = _kernel_batch(lm0, aa, em, uniforms)
        assert lm_wide.sum() > 0, f"emitter {e} deposited nothing"
        close = np.isclose(lm_wide, lm_xla, rtol=1e-3, atol=1e-2)
        assert close.mean() > 0.999, (
            f"emitter {e}: only {close.mean():.4%} of texels match"
        )
        np.testing.assert_allclose(lm_wide.sum(), lm_xla.sum(), rtol=1e-4)


@pytest.mark.parametrize("seed", range(10))
def test_fuzzed_wide_matches_xla_shared_draws(seed, tmp_path):
    """Engine parity on the same randomized multi-room layouts the scene
    fuzzer generates: first + last emitter of each scene (windows AND the
    synthetic ceiling lights of windowless rooms)."""
    png = tmp_path / f"fuzz_{seed}.png"
    _random_layout(seed, png)
    img = im.load_layout(str(png))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)
    _assert_wide_matches_xla(scene, uniforms_key=100 + seed)


def _compile(arr, tmp_path, name):
    png = tmp_path / name
    Image.fromarray(arr, "RGB").save(png)
    img = im.load_layout(str(png))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    return geometry.Scene(lay)


def test_room_near_image_edge(tmp_path):
    """A room whose outer wall shell sits 1 px from the image border: the
    transition scans and the distance transform touch the clamped-read
    boundary (image.c:61-66) and the compiled scene must still trace
    identically on both engines."""
    h, w = 30, 40
    arr = np.zeros((h, w, 3), np.uint8)
    arr[:, :] = OUTSIDE
    arr[1:h - 1, 1:w - 1] = WALL
    arr[3:h - 3, 3:w - 3] = EMPTY
    arr[1:3, 10:16] = WINDOW   # window through the border-hugging wall
    scene = _compile(arr, tmp_path, "edge.png")
    assert len(scene.windows) == 1
    _assert_wide_matches_xla(scene)


def test_window_in_room_corner(tmp_path):
    """A window flush against the room's corner: the emitter rect abuts a
    perpendicular wall, so first-bounce hits land exactly on rect borders
    (the u/v in [0, len] boundary of the intersection test and the
    wt-1/ht-1 texel clamp)."""
    h, w = 36, 44
    arr = np.zeros((h, w, 3), np.uint8)
    arr[:, :] = OUTSIDE
    arr[6:h - 6, 6:w - 6] = WALL
    arr[8:h - 8, 8:w - 8] = EMPTY
    arr[6:8, 8:14] = WINDOW    # starts at the room's left corner (x=8)
    scene = _compile(arr, tmp_path, "corner.png")
    assert len(scene.windows) == 1
    _assert_wide_matches_xla(scene)


def test_group_axis_zero():
    """A hand-built scene with NO y-facing rects: pack_aa's group_counts
    gets a zero axis, which the kernel must skip without disturbing
    the running minimum (the `if count == 0: continue` path has no layout
    fixture — every compiled apartment has all three axes)."""
    from flatmatch.scene.rectangle import create_rect, num_mipmap_texels

    ts = 200.0
    # pack_aa's axis form: z-normal rects span width on x / height on y,
    # x-normal rects width on y / height on z; n = height x width, so the
    # normal's sign comes from the span signs (like _add_horizontal's
    # negative-dx floors, scene/layout.py:225-229)
    rects_list = [
        # floor (n = +z, up) and ceiling (n = -z, down)
        create_rect((2, 0, 0), (-2, 0, 0), (0, 2, 0), ts),
        create_rect((0, 0, 2.6), (2, 0, 0), (0, 2, 0), ts),
        # two x-facing walls; the y ends stay OPEN (escaping photons die)
        create_rect((0, 2, 0), (0, -2, 0), (0, 0, 2.6), ts),  # n = +x
        create_rect((2, 0, 0), (0, 2, 0), (0, 0, 2.6), ts),   # n = -x
    ]
    base = 0
    for r in rects_list:
        r.base = base
        base += num_mipmap_texels(r)
    rects = pack_rects(rects_list)
    aa = pack_aa(rects_list)
    assert aa is not None
    assert 0 in tuple(aa.group_counts), aa.group_counts

    # downward-facing ceiling lamp in the middle of the open tube
    em = photon.EmitterSlice(
        pos=jnp.asarray([0.8, 0.8, 2.59], jnp.float32),
        wvec=jnp.asarray([0.4, 0.0, 0.0], jnp.float32),
        hvec=jnp.asarray([0.0, 0.4, 0.0], jnp.float32),
        n=jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
        color=jnp.asarray(CFG.light_color, jnp.float32),
        is_window=jnp.asarray(0.0, jnp.float32),
    )
    U = photon.uniforms_per_photon(CFG.max_depth)
    uniforms = jax.random.uniform(
        jax.random.PRNGKey(11), (B, U), dtype=np.float32
    )
    lm0 = jnp.zeros((base, 3), jnp.float32)
    lm_xla = np.asarray(
        jax.jit(photon.trace_batch, static_argnames=("cfg",))(
            lm0, rects, em, uniforms, B, CFG
        )
    )
    lm_wide = _kernel_batch(lm0, aa, em, uniforms)
    assert lm_wide.sum() > 0
    close = np.isclose(lm_wide, lm_xla, rtol=1e-3, atol=1e-2)
    assert close.mean() > 0.999, f"only {close.mean():.4%} match"
    np.testing.assert_allclose(lm_wide.sum(), lm_xla.sum(), rtol=1e-4)
