"""Debug first-hit raytracer: geometry sanity + regression."""
import numpy as np
import pytest

from flatmatch.debug.raytrace import Camera, render_first_hit, rect_index_colors
from flatmatch.ops.device_scene import pack_rects
from flatmatch.scene import geometry, image as im, layout
from tests.conftest import FIXTURES

f32 = np.float32


@pytest.fixture(scope="module")
def mini():
    img = im.load_layout(str(FIXTURES / "mini.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)
    return scene, pack_rects(scene.walls)


def test_colors_unique_prefix():
    c = rect_index_colors(125)
    assert len(np.unique(c.reshape(-1, 3), axis=0)) == 125


def test_interior_camera_sees_walls(mini):
    scene, rects = mini
    sp = scene.layout.starting_position
    cam = Camera(
        position=(sp[0], sp[1], 1.3),
        direction=(1.0, 0.3, 0.0),
        width=160,
        height=120,
        pixel_pitch=1 / 100.0,
    )
    img = render_first_hit(scene, rects, cam)
    assert img.shape == (120, 160, 4)
    # from inside a closed room every ray hits something
    assert (img[..., 3] == 255).all()
    # multiple distinct surfaces visible
    n_colors = len(np.unique(img[..., :3].reshape(-1, 3), axis=0))
    assert n_colors >= 4


def test_render_deterministic(mini):
    scene, rects = mini
    cam = Camera(width=64, height=48, pixel_pitch=0.01)
    a = render_first_hit(scene, rects, cam)
    b = render_first_hit(scene, rects, cam)
    np.testing.assert_array_equal(a, b)


def test_cli_debug_command(tmp_path):
    """`cli debug` writes the first-hit PNG from the starting position
    (the debugRaytracer.cc harness as a user-reachable command)."""
    from PIL import Image

    from flatmatch.cli import main

    out = tmp_path / "dbg.png"
    rc = main([
        "debug", str(FIXTURES / "mini.png"), "30",
        "--out", str(out), "--width", "192", "--height", "128",
    ])
    assert rc == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (128, 192, 4)
    assert (img[..., 3] == 255).all()  # interior camera: every ray hits
    assert len(np.unique(img[..., :3].reshape(-1, 3), axis=0)) >= 3
