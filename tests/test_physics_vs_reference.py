"""Cross-implementation physics check: our photon engine vs the ACTUAL
reference C engine (PHOTON_NATIVE) on the same scene and photon budget.

The two implementations use different RNGs (threefry vs libc rand), so
agreement is distribution-level: per-wall mean radiance within Monte-Carlo
tolerance. Fixtures were dumped from a reference build:
tests/fixtures/{tiny,mini}_photon_native_spa*.f32 (numTexels x cl_float4,
raw un-normalized deposit sums, srand(12345))."""
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.engines import schedule
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.scene import geometry, image as im, layout
from flatmatch.scene.rectangle import num_tiles

f32 = np.float32

CASES = [
    ("tiny", "tiny_photon_native_spa400k.f32", 400000.0),
    ("mini", "mini_photon_native_spa200k.f32", 200000.0),
]

# the flagship scene: the reference's only shipped input (README.md:27),
# rebuilt from its rect dump, with the reference engine's texels dumped
# from the same reference build at samplesPerArea=300000 (4.6M photons,
# srand(12345)) — the benchmark scene gets the same distribution-level
# physics gate as the small fixtures
EXAMPLE_CASE = (
    "example_rects.txt",
    "example_photon_native_spa300k.f32",
    300000.0,
)


@pytest.mark.parametrize("name,fixture,spa", CASES)
def test_wall_energy_matches_reference_engine(name, fixture, spa):
    from tests.conftest import FIXTURES

    img = im.load_layout(str(FIXTURES / f"{name}.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)
    gold = np.fromfile(FIXTURES / fixture, dtype="<f4").reshape(
        scene.num_texels, 4
    )[:, :3]

    cfg = PhotonConfig(samples_per_area=spa, photons_per_batch=4096, seed=3)
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, spa, cfg.window_color, cfg.light_color
    )
    ours = np.asarray(
        schedule.render_photons(rects, emitters, scene.num_texels, cfg)
    )

    # total deposited energy within MC noise
    np.testing.assert_allclose(ours.sum(), gold.sum(), rtol=0.02)

    # per-wall mean radiance: compare walls receiving meaningful energy
    checked = 0
    for i, r in enumerate(scene.walls):
        sl = slice(r.base, r.base + num_tiles(r))
        o = ours[sl].mean()
        g = gold[sl].mean()
        if g > gold.sum() / scene.num_texels * 0.1:  # skip near-dark walls
            # MC noise on a wall mean scales ~1/sqrt(texels x deposits);
            # tiny frame rects (4-32 texels) sit at ~3-4% sigma
            rtol = 0.12 if num_tiles(r) >= 64 else 0.25
            np.testing.assert_allclose(
                o, g, rtol=rtol,
                err_msg=f"{name} wall {i} mean radiance",
            )
            checked += 1
    assert checked >= 5, f"only {checked} walls carried energy"

    # per-texel correlation: the spatial light distribution must match
    a, b = ours.ravel(), gold.ravel()
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.98, f"texel correlation {corr}"


def test_example_scene_matches_reference_engine():
    """Lightmap-level physics parity on example.png (the benchmark scene)."""
    from tests.conftest import FIXTURES

    from flatmatch.scene.rect_dump import load_rect_dump

    dump, fixture, spa = EXAMPLE_CASE
    scene = load_rect_dump(FIXTURES / dump)
    gold = np.fromfile(FIXTURES / fixture, dtype="<f4").reshape(
        scene.num_texels, 4
    )[:, :3]

    cfg = PhotonConfig(
        samples_per_area=spa, photons_per_batch=65536, seed=3
    )
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(scene, spa, cfg.window_color, cfg.light_color)
    ours = np.asarray(
        schedule.render_photons(rects, emitters, scene.num_texels, cfg)
    )

    np.testing.assert_allclose(ours.sum(), gold.sum(), rtol=0.02)

    checked = 0
    for i, r in enumerate(scene.walls):
        sl = slice(r.base, r.base + num_tiles(r))
        o = ours[sl].mean()
        g = gold[sl].mean()
        if g > gold.sum() / scene.num_texels * 0.1:
            rtol = 0.12 if num_tiles(r) >= 64 else 0.25
            np.testing.assert_allclose(
                o, g, rtol=rtol, err_msg=f"example wall {i} mean radiance"
            )
            checked += 1
    assert checked >= 20, f"only {checked} walls carried energy"

    corr = np.corrcoef(ours.ravel(), gold.ravel())[0, 1]
    assert corr > 0.98, f"texel correlation {corr}"
