"""Native C++ raster kernels vs the NumPy/SciPy reference implementations.

The scene-compiler parity suite (test_scene_parity.py) already exercises the
native path end-to-end when available (image.py dispatches to it); these
tests pin the kernels against the portable implementations directly.
"""
import numpy as np
import pytest
from scipy import ndimage

from flatmatch import native
from flatmatch.scene import image as im
from tests.conftest import FIXTURES

pytestmark = [
    pytest.mark.fast,
    pytest.mark.skipif(not native.available(), reason="no C++ toolchain"),
]


@pytest.fixture(scope="module")
def layouts():
    return [
        im.load_layout(str(FIXTURES / "tiny.png")),
        im.load_layout(str(FIXTURES / "mini.png")),
    ]


def test_distance_transform_matches_scipy(layouts):
    rng = np.random.default_rng(0)
    cases = [rng.random((40, 60)) < 0.1, rng.random((33, 7)) < 0.02]
    cases += [(l == im.WALL) for l in layouts]
    cases += [np.zeros((5, 5), bool), np.ones((4, 4), bool)]
    for mask in cases:
        ours, omax = native.distance_transform(mask)
        seeds = mask != 0
        if not seeds.any():
            assert omax == 0 and (ours == 0).all()
            continue
        ref = ndimage.distance_transform_cdt(
            ~seeds, metric="chessboard"
        ).astype(np.int64) + 1
        ref[seeds] = 1
        np.testing.assert_array_equal(ours, ref)
        assert omax == ref.max()


def test_flood_fill_matches_scipy(layouts):
    for lay in layouts:
        a = lay.copy()
        b = lay.copy()
        ys, xs = np.nonzero(lay == im.EMPTY)
        y, x = int(ys[0]), int(xs[0])
        native.flood_fill(a, x, y, 0xFF123456, im.EMPTY)
        bg = b == im.EMPTY
        labels, _ = ndimage.label(bg, structure=np.ones((3, 3), bool))
        b[labels == labels[y, x]] = np.uint32(0xFF123456)
        np.testing.assert_array_equal(a, b)


def test_dilate_matches_scipy(layouts):
    rng = np.random.default_rng(1)
    cases = [rng.random((50, 70)) < 0.05] + [(l == im.WALL) for l in layouts]
    for mask in cases:
        for radius in (1, 5):
            ours = native.dilate_mask(mask, radius)
            k = np.ones((2 * radius + 1, 2 * radius + 1), bool)
            ref = ndimage.binary_dilation(mask, structure=k)
            np.testing.assert_array_equal(ours, ref)


def test_rle_roundtrip():
    rng = np.random.default_rng(2)
    mask = rng.random(1000) < 0.3
    runs = native.rle(mask, first_value=True)
    # reconstruct
    out = []
    val = True
    for r in runs:
        out.extend([val] * int(r))
        val = not val
    np.testing.assert_array_equal(np.array(out), mask)
    assert runs.sum() == mask.size


def test_decompose_covers_exactly(layouts):
    for lay in layouts:
        img = lay.copy()
        rects = native.decompose(img, im.INVALIDATED)
        # everything invalidated afterwards
        assert (img == im.INVALIDATED).all()
        # rectangles tile the raster exactly once with matching colors
        cover = np.zeros(lay.shape, np.int32)
        for x0, y0, x1, y1, color in rects:
            assert (lay[y0:y1, x0:x1] == np.uint32(color)).all()
            cover[y0:y1, x0:x1] += 1
        np.testing.assert_array_equal(cover, 1)
