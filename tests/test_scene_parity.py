"""Golden-parity tests for the scene compiler against fixtures generated from
the reference implementation (parseLayout/geometry/collision outputs on
tests/fixtures/{tiny,mini}.png and /root/reference/example.png)."""
import pathlib

import numpy as np
import pytest

from flatmatch.scene import collision, geometry, image as im, layout
from flatmatch.scene.rect_dump import parse_rect_dump as parse_rects_fixture
from tests.conftest import FIXTURES, REFERENCE

pytestmark = pytest.mark.fast

CASES = [
    ("tiny", FIXTURES / "tiny.png"),
    ("mini", FIXTURES / "mini.png"),
    pytest.param(
        "example",
        REFERENCE / "example.png",
        marks=pytest.mark.skipif(
            not (REFERENCE / "example.png").exists(), reason="reference not mounted"
        ),
    ),
]


def _parse(png_path):
    img = im.load_layout(str(png_path))
    return img, layout.parse_layout(img, np.float32(1.0) / np.float32(30.0), 200.0)


@pytest.mark.parametrize("name,png", CASES)
def test_counts_and_rects(name, png):
    header, groups = parse_rects_fixture(FIXTURES / f"{name}_rects.txt")
    img, lay = _parse(png)

    assert len(lay.walls) == header["walls"]
    assert len(lay.windows) == header["windows"]
    assert len(lay.lights) == header["lights"]
    assert len(lay.box) == header["box"]
    assert lay.num_texels == header["texels"]
    assert (lay.width, lay.height) == (header["width"], header["height"])
    np.testing.assert_array_equal(
        np.float32(lay.starting_position), np.float32(header["start"])
    )

    for gname, rects in (
        ("walls", lay.walls),
        ("windows", lay.windows),
        ("lights", lay.lights),
        ("box", lay.box),
    ):
        gold = groups[gname]
        assert len(rects) == len(gold)
        for i, (r, g) in enumerate(zip(rects, gold)):
            ctx = f"{name}/{gname}[{i}]"
            np.testing.assert_array_equal(r.pos, g["pos"], err_msg=ctx)
            np.testing.assert_array_equal(r.width, g["width"], err_msg=ctx)
            np.testing.assert_array_equal(r.height, g["height"], err_msg=ctx)
            np.testing.assert_array_equal(r.n, g["n"], err_msg=ctx)
            assert (r.wtiles, r.htiles) == (g["wtiles"], g["htiles"]), ctx
            if gname == "walls":
                assert r.base == g["base"], ctx


@pytest.mark.parametrize("name,png", CASES)
def test_geometry_json(name, png):
    img, lay = _parse(png)
    ours = geometry.geometry_json(geometry.Scene(lay))
    gold = (FIXTURES / f"{name}_geometry.json").read_text()
    assert ours == gold


@pytest.mark.parametrize("name,png", CASES)
def test_collision_map(name, png):
    img = im.load_layout(str(png))
    ours = collision.build_collision_map(img)
    gold = (FIXTURES / f"{name}_collisionMap.json").read_text()
    assert ours == gold


@pytest.mark.parametrize("name", ["tiny", "mini", "example"])
def test_rect_dump_scene_writes_reference_geometry_json(name):
    """A scene loaded from its rect dump (scene/rect_dump.py) is the scene
    the layout compiles to: geometry.json byte-equal to the reference's."""
    from flatmatch.scene.geometry import geometry_json
    from flatmatch.scene.rect_dump import load_rect_dump

    scene = load_rect_dump(FIXTURES / f"{name}_rects.txt")
    assert geometry_json(scene) == (
        FIXTURES / f"{name}_geometry.json"
    ).read_text()
