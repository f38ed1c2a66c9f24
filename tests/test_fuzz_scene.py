"""Property-based fuzzing of the scene compiler.

Random (seeded, deterministic) multi-room layouts in the reference's color
vocabulary (/root/reference/parseLayout.c:15-24) must always compile into a
structurally sound scene: axis-aligned rects the wide engine accepts,
a non-overlapping texel arena that exactly accounts for every mipmap
chain, a collision map whose RLE covers the raster with a passable
starting position, and a renderable emitter set. The generator varies room
count/sizes, window classes (plain/balcony), inter-room doors, and
windowless rooms (forcing the synthetic ceiling-light path,
parseLayout.c:168-341).
"""
import json

import numpy as np
import pytest
from PIL import Image

from flatmatch.scene import geometry, image as im, layout
from flatmatch.scene.collision import build_collision_map
from flatmatch.scene.rectangle import num_mipmap_texels

f32 = np.float32

WALL = (0, 0, 0)
EMPTY = (255, 255, 255)
OUTSIDE = (127, 127, 127)
DOOR = (223, 223, 223)
WINDOW = (0, 255, 0)
BALCONY_WINDOW = (0, 127, 255)


def _random_layout(seed: int, path):
    """A 1- or 2-row grid of rooms behind a 2px wall shell; seeded and
    deterministic.

    Room (0,0) always gets an outer-wall window (daylight); other rooms
    get a window, a balcony window, or nothing (windowless rooms must
    receive a synthetic ceiling light). Horizontally adjacent rooms
    connect through doors; in 2-row layouts (seeds >= 6) some vertical
    neighbors connect too — the second row exercises the greedy area
    decomposition and light placement on taller interiors."""
    rng = np.random.RandomState(seed)
    n_rooms = int(rng.randint(1, 5))
    n_rows = 2 if seed >= 6 else 1
    widths = rng.randint(10, 26, size=n_rooms)
    height = int(rng.randint(14, 38))
    total_w = 6 + 2 + int(widths.sum()) + 2 * n_rooms + 6
    total_h = 6 + 2 + (height + 2) * n_rows + 6
    img = np.zeros((total_h, total_w, 3), np.uint8)
    img[:, :] = OUTSIDE
    img[6:total_h - 6, 6:total_w - 6] = WALL

    win_kinds = []
    for row in range(n_rows):
        y0 = 8 + row * (height + 2)
        y1 = y0 + height
        x = 8
        for r in range(n_rooms):
            x1 = x + int(widths[r])
            img[y0:y1, x:x1] = EMPTY
            if row == 0 and r == 0:
                kind = WINDOW
            elif row == 0:
                kind = [WINDOW, BALCONY_WINDOW, None][int(rng.randint(3))]
            else:
                kind = None  # second row has no outer top wall: windowless
            win_kinds.append(kind)
            if kind is not None:
                # window in the top outer wall band (rows 6..8 border
                # OUTSIDE)
                wx0 = x + 2 + int(rng.randint(max(1, widths[r] - 8)))
                wx1 = min(x1 - 2, wx0 + int(rng.randint(3, 8)))
                if wx1 > wx0:
                    img[6:8, wx0:wx1] = kind
            if r > 0:
                # door through the 2px wall to the left neighbor
                dy0 = y0 + 2 + int(rng.randint(max(1, height - 10)))
                dy1 = min(y1 - 2, dy0 + int(rng.randint(4, 9)))
                if dy1 > dy0:
                    img[dy0:dy1, x - 2:x] = DOOR
            if row == 1 and rng.randint(2):
                # door through the 2px wall to the upstairs-row neighbor
                dx0 = x + 2 + int(rng.randint(max(1, widths[r] - 8)))
                dx1 = min(x1 - 2, dx0 + int(rng.randint(4, 9)))
                if dx1 > dx0:
                    img[y0 - 2:y0, dx0:dx1] = DOOR
            x = x1 + 2
    Image.fromarray(img, "RGB").save(path)
    return win_kinds


@pytest.mark.parametrize("seed", range(10))
def test_fuzzed_layout_compiles_sound(seed, tmp_path):
    png = tmp_path / f"fuzz_{seed}.png"
    win_kinds = _random_layout(seed, png)
    img = im.load_layout(str(png))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)

    # every rect is axis-aligned and the wide engine accepts the scene
    from flatmatch.ops.aa_scene import pack_aa

    aa = pack_aa(scene.walls)
    assert aa is not None
    assert sum(aa.group_counts) == len(scene.walls)
    assert len(scene.walls) >= 6  # 4 shell walls + floor + ceiling

    # texel arena: mipmap chains tile it exactly, no overlap, no holes
    chains = sorted(
        # num_mipmap_texels includes level 0 (the full pyramid)
        (r.base, num_mipmap_texels(r)) for r in scene.walls
    )
    at = 0
    for base, count in chains:
        assert base == at, (base, at)
        at += count
    assert at == scene.num_texels

    # emitters: room 0 always has a window; windowless rooms got lights
    assert len(scene.windows) >= 1
    n_windowless = sum(1 for k in win_kinds if k is None)
    if n_windowless:
        assert len(scene.lights) >= 1

    # geometry JSON parses and covers every wall
    geo = json.loads(geometry.geometry_json(scene))
    assert len(geo["geometry"]) == len(scene.walls)
    assert geo["layoutImageSize"] == [img.shape[1], img.shape[0]]

    # collision map: RLE covers the raster; start position is passable
    rle = json.loads(build_collision_map(img))
    assert sum(rle) == img.shape[0] * img.shape[1]
    flat = np.zeros(img.shape[0] * img.shape[1], bool)
    at, passable = 0, False  # first run impassable (parseLayout.c:543)
    for run in rle:
        flat[at:at + run] = passable
        at += run
        passable = not passable
    grid = flat.reshape(img.shape[0], img.shape[1])
    sx, sy = lay.starting_position
    assert grid[int(sy * 30.0), int(sx * 30.0)]

    # the scene renders: one small XLA photon pass with finite energy
    from flatmatch.config import PhotonConfig
    from flatmatch.engines import schedule
    from flatmatch.ops.device_scene import pack_emitters, pack_rects

    cfg = PhotonConfig(samples_per_area=300.0, photons_per_batch=256, seed=1)
    emitters = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    lm = np.asarray(
        schedule.render_photons(
            pack_rects(scene.walls), emitters, scene.num_texels, cfg
        )
    )
    assert np.isfinite(lm).all() and (lm >= 0).all() and lm.sum() > 0


@pytest.mark.slow
def test_tiled_flagship_scene_scales_exactly():
    """Scene-scale stress at the COMPILER level (round-4 VERDICT #2): a
    2x2 tiling of the flagship layout (tests/fixtures/make_layout.tiled,
    each tile keeps its OUTSIDE border) must parse to exactly 4 disjoint
    copies — 4x the walls/windows/lights/texels, with per-copy wall
    geometry identical to the base scene up to the tile translation —
    and the XLA engine renders it with finite positive energy. This is
    the host-side gate behind the on-chip capacity measurements in
    docs/DESIGN.md (tools/stress_scale.py)."""
    import pathlib

    from flatmatch.scene import geometry as geo

    import sys as _sys

    from tests.conftest import FIXTURES

    if str(FIXTURES) not in _sys.path:
        _sys.path.insert(0, str(FIXTURES))
    from make_layout import tiled

    src = pathlib.Path("/root/reference/example.png")
    if not src.exists():
        pytest.skip("reference fixture unavailable")
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        dst = pathlib.Path(td) / "stress_2x2.png"
        tiled(str(src), str(dst), 2, 2)

        img1 = im.load_layout(str(src))
        lay1 = layout.parse_layout(img1, f32(1.0) / f32(30.0), 200.0)
        img4 = im.load_layout(str(dst))
        lay4 = layout.parse_layout(img4, f32(1.0) / f32(30.0), 200.0)

    assert len(lay4.walls) == 4 * len(lay1.walls)
    assert len(lay4.windows) == 4 * len(lay1.windows)
    assert len(lay4.lights) == 4 * len(lay1.lights)
    assert lay4.num_texels == 4 * lay1.num_texels

    # each copy's walls are the base walls translated by the tile offset.
    # NOT bit-exact: spans are computed from absolute positions
    # (f32(x1*s) - f32(x0*s), parseLayout.c arithmetic), so a translated
    # copy's span can differ in the last ulp — which flips the
    # power-of-two sizing loop's tie on near-square walls (8x16 <-> 16x8,
    # same texel count; the reference C code behaves identically on a
    # tiled PNG). The key therefore matches position/span to 4 decimals
    # and the tile COUNT, not the grid orientation.
    w_m = f32(img1.shape[1]) * (f32(1.0) / f32(30.0))
    h_m = f32(img1.shape[0]) * (f32(1.0) / f32(30.0))

    def key(r, ox, oy):
        return (
            round(float(r.pos[0]) - ox, 4), round(float(r.pos[1]) - oy, 4),
            round(float(r.pos[2]), 4),
            tuple(np.round(r.width, 4)), tuple(np.round(r.height, 4)),
            r.wtiles * r.htiles,
        )

    base_keys = sorted(key(r, 0.0, 0.0) for r in lay1.walls)
    for ox, oy in ((0, 0), (w_m, 0), (0, h_m), (w_m, h_m)):
        copy_keys = sorted(
            key(r, ox, oy) for r in lay4.walls
            if ox <= float(r.pos[0] + 1e-3)
            and float(r.pos[0]) < ox + w_m + 1e-3
            and oy <= float(r.pos[1] + 1e-3)
            and float(r.pos[1]) < oy + h_m + 1e-3
        )
        assert copy_keys == base_keys, f"copy at offset ({ox},{oy}) differs"

    # the stress scene renders (tiny budget, XLA engine)
    from flatmatch.config import PhotonConfig
    from flatmatch.engines import schedule
    from flatmatch.ops.device_scene import pack_emitters, pack_rects

    scene = geo.Scene(lay4)
    cfg = PhotonConfig(samples_per_area=20.0, photons_per_batch=512, seed=2)
    emitters = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    lm = np.asarray(schedule.render_photons(
        pack_rects(scene.walls), emitters, scene.num_texels, cfg
    ))
    assert np.isfinite(lm).all() and lm.sum() > 0
