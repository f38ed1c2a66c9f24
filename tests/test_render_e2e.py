"""End-to-end pipeline test: layout PNG in -> JSONs + lightmap tiles out
(the minimum end-to-end slice of SURVEY.md §7 step 3)."""
import dataclasses

import numpy as np
import pytest
from PIL import Image as PILImage

from flatmatch.config import DEFAULT_CONFIG, Engine
from flatmatch.io import tiles as tiles_io
from flatmatch.render import render
from flatmatch.scene.rectangle import num_tiles
from tests.conftest import FIXTURES


def _cfg(engine):
    cfg = DEFAULT_CONFIG.replace(engine=engine)
    return cfg.replace(
        photon=dataclasses.replace(
            cfg.photon, samples_per_area=5000.0, photons_per_batch=1024
        )
    )


def test_photon_end_to_end(tmp_path):
    res = render(
        str(FIXTURES / "tiny.png"), str(tmp_path), 30.0, _cfg(Engine.PHOTON_XLA)
    )
    # artifacts exist and match the scene-compiler goldens byte-for-byte
    assert (tmp_path / "collisionMap.json").read_text() == (
        FIXTURES / "tiny_collisionMap.json"
    ).read_text()
    assert (tmp_path / "geometry.json").read_text() == (
        FIXTURES / "tiny_geometry.json"
    ).read_text()
    assert len(res.tile_paths) == len(res.scene.walls)
    for p, rect in zip(res.tile_paths, res.scene.walls):
        img = PILImage.open(p)
        assert img.size == (rect.wtiles, rect.htiles)
    assert np.isfinite(res.texels).all()
    assert res.texels.sum() > 0  # some light arrived somewhere


def test_raw_tile_roundtrip(tmp_path):
    res = render(
        str(FIXTURES / "tiny.png"), str(tmp_path), 30.0, _cfg(Engine.PHOTON_XLA)
    )
    rect = res.scene.walls[0]
    path = tmp_path / "tile_0.raw"
    tiles_io.save_tile_raw(rect, res.texels, str(path))
    meta, data = tiles_io.load_tile_raw(str(path))
    assert (meta["wtiles"], meta["htiles"]) == (rect.wtiles, rect.htiles)
    np.testing.assert_array_equal(meta["pos"], rect.pos)
    np.testing.assert_array_equal(
        data.reshape(-1, 3), res.texels[rect.base : rect.base + num_tiles(rect)]
    )


def test_oracle_engine_end_to_end(tmp_path):
    res = render(
        str(FIXTURES / "tiny.png"),
        str(tmp_path),
        30.0,
        _cfg(Engine.PHOTON_ORACLE),
    )
    assert np.isfinite(res.texels).all()
    assert res.texels.sum() > 0


def test_preview_progressive_tiles(tmp_path, monkeypatch):
    """`preview=True` re-writes the tiles after every dispatch segment with
    done-fraction exposure scaling, and the final result is bit-identical
    to a plain run (segmentation never changes a photon)."""
    import sys

    import flatmatch.render  # noqa: F401  (package attr shadows module)

    render_mod = sys.modules["flatmatch.render"]

    cfg = _cfg(Engine.PHOTON_XLA)
    # several segments: 1024-photon batches, 1 batch per segment
    cfg = cfg.replace(
        photon=dataclasses.replace(cfg.photon, samples_per_area=20000.0)
    )
    plain = render(str(FIXTURES / "tiny.png"), str(tmp_path / "a"), 30.0, cfg)

    calls = []
    real_save = tiles_io.save_tiles

    def spy(walls, texels, out_dir, tint_extra, dilate_seams=False):
        calls.append(np.asarray(texels).sum())
        return real_save(walls, texels, out_dir, tint_extra, dilate_seams)

    monkeypatch.setattr(render_mod.tiles_io, "save_tiles", spy)
    prev = render(
        str(FIXTURES / "tiny.png"), str(tmp_path / "b"), 30.0, cfg,
        preview=True,
    )
    # preview segments fired (one per emitter segment; tiny has a single
    # window emitter) plus the final write; energies finite and positive
    assert len(calls) >= 2
    assert all(np.isfinite(c) and c > 0 for c in calls)
    np.testing.assert_array_equal(prev.texels, plain.texels)
    # the last preview covers the full budget (done == total), so its
    # scaled energy equals the final write's exactly
    np.testing.assert_allclose(calls[-2], calls[-1], rtol=1e-6)


def test_preview_wide_engine_interpret(tmp_path):
    """The preview hook on the trace-kernel engine fires after every
    segment, the last call covers the whole budget, and watching a render
    does not change it (interpret mode)."""
    from flatmatch.engines import schedule
    from flatmatch.engines.photon_triton import KernelSpec
    from flatmatch.ops.aa_scene import pack_aa
    from flatmatch.ops.device_scene import pack_emitters, pack_rects
    from flatmatch.scene.rect_dump import load_rect_dump

    scene = load_rect_dump(FIXTURES / "tiny_rects.txt")
    rects = pack_rects(scene.walls)
    cfg = dataclasses.replace(
        _cfg(Engine.PHOTON_PALLAS).photon,
        samples_per_area=20000.0, photons_per_batch=1024, device_rng=True,
        checkpoint_every=2,
    )
    emitters = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    aa = pack_aa(scene.walls)
    kernel = KernelSpec(aa.group_counts, interpret=True)
    seen = []
    fast = np.asarray(schedule.render_photons(
        rects, emitters, scene.num_texels, cfg, kernel=kernel, aa=aa))
    seg = np.asarray(schedule.render_photons(
        rects, emitters, scene.num_texels, cfg, kernel=kernel, aa=aa,
        on_segment=lambda lm, d, t: seen.append((d, t)),
    ))
    np.testing.assert_array_equal(fast, seg)
    assert len(seen) >= 2
    assert seen[-1][0] == seen[-1][1]  # last segment completes the budget
    assert [d for d, _ in seen] == sorted(d for d, _ in seen)


def test_seam_dilate_semantics():
    """Boundary pixels (black+lit 8-neighborhood) take the brightest 3x3
    neighbor; interior lit and interior black regions are untouched."""
    import numpy as np

    from flatmatch.io.tiles import seam_dilate

    img = np.zeros((5, 8, 3), np.uint8)
    img[:, 4:] = (10, 20, 30)     # lit half
    img[2, 6] = (200, 10, 0)      # a bright pixel inside the lit half
    out = seam_dilate(img)
    # interior black stays black
    assert (out[:, :3] == 0).all()
    # boundary columns (3: black side, 4: lit side) are filled/brightened
    assert (out[:, 3].sum(-1) > 0).all()
    assert (out[:, 4].sum(-1) >= img[:, 4].sum(-1)).all()
    # the brightest-neighbor rule: pixels adjacent to the bright spot in
    # boundary-free interior keep their value (no black neighbors there)
    assert tuple(out[2, 6]) == (200, 10, 0)
    # idempotent on a fully lit image
    lit = np.full((4, 4, 3), 7, np.uint8)
    assert (seam_dilate(lit) == lit).all()


def test_cli_dilate_seams_smoke(tmp_path):
    from flatmatch import cli
    from tests.conftest import FIXTURES

    rc = cli.main([
        "render", str(FIXTURES / "tiny.png"), "30",
        "--engine", "photon_xla",
        "--samples-per-area", "2000", "--photons-per-batch", "512",
        "--out", str(tmp_path), "--dilate-seams",
    ])
    assert rc == 0
    assert list((tmp_path / "tiles").glob("tile_*.png"))


def test_downsample_supersampled_semantics():
    """The supersampled downsample (imageProcessing.c:145-184 hint):
    each output texel averages its ss*ss sub-texel block EXCLUDING
    sub-texels with any zero channel; an all-zero block stays zero."""
    from flatmatch.render import downsample_supersampled
    from flatmatch.scene.rectangle import Rect

    class _S:  # minimal scene stand-ins
        def __init__(self, walls, num_texels):
            self.walls = walls
            self.num_texels = num_texels

    r = Rect(pos=np.zeros(3, np.float32), width=np.zeros(3, np.float32),
             height=np.zeros(3, np.float32), n=np.zeros(3, np.float32),
             base=0, wtiles=2, htiles=1)
    r2 = Rect(pos=r.pos, width=r.width, height=r.height, n=r.n,
              base=0, wtiles=4, htiles=2)
    tex = np.zeros((8, 3), np.float32)
    # texel 0's block = cols 0-1 of both rows: one lit, one half-lit
    # (zero g channel -> excluded), two zero
    tex[0] = (4.0, 8.0, 12.0)
    tex[4] = (99.0, 0.0, 99.0)    # any-zero channel: excluded
    # texel 1's block (cols 2-3) stays all-zero
    out = downsample_supersampled(_S([r], 2), _S([r2], 8), tex, 2)
    np.testing.assert_allclose(out[0], (4.0, 8.0, 12.0))
    np.testing.assert_allclose(out[1], (0.0, 0.0, 0.0))


def test_render_composition_supersample_dilate_preview(tmp_path):
    """Composition e2e (round-4 VERDICT #8): --supersample + --dilate-seams
    + --preview together. preview is incompatible with supersample and must
    WARN + disable itself (render.py), the supersampled render must still
    complete, and the dilated export must differ from a plain export only
    where unlit seam texels were filled."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        res = render(
            str(FIXTURES / "tiny.png"), str(tmp_path), 30.0,
            _cfg(Engine.PHOTON_XLA), supersample=2, dilate_seams=True,
            preview=True,
        )
    assert "--preview is unsupported with --supersample" in err.getvalue()
    assert "preview tiles at" not in buf.getvalue()  # really disabled
    assert len(res.tile_paths) == len(res.scene.walls)
    for p, rect in zip(res.tile_paths, res.scene.walls):
        img = PILImage.open(p)
        assert img.size == (rect.wtiles, rect.htiles)
    assert np.isfinite(res.texels).all() and res.texels.sum() > 0


def test_supersampled_scene_flagship_grids():
    """Regression (round-4 ADVICE): the supersampled twin must scale EVERY
    wall's tile grid by exactly ss per dimension. Re-running the
    power-of-two sizing loop (rectangle.c:15-57) at ss^2 x density does
    NOT guarantee that for elongated walls (it can spend both doublings
    on one axis: 1x32 -> 1x128 instead of 2x64); the twin is built by
    direct grid scaling instead. Asserted on the flagship scene, where
    the density-loop approach demonstrably fails for several walls."""
    import pathlib

    from flatmatch.config import DEFAULT_CONFIG
    from flatmatch.render import supersampled_scene
    from flatmatch.scene import geometry, image as im, layout
    from flatmatch.scene.rectangle import create_rect, num_mipmap_texels

    png = pathlib.Path("/root/reference/example.png")
    if not png.exists():
        png = FIXTURES / "mini.png"
    img = im.load_layout(str(png))
    lay = layout.parse_layout(img, np.float32(1.0) / np.float32(30.0), 200.0)
    scene = geometry.Scene(lay)
    ss = 2
    twin = supersampled_scene(scene, ss, DEFAULT_CONFIG)
    total = 0
    for r, r2 in zip(scene.walls, twin.walls):
        assert (r2.wtiles, r2.htiles) == (r.wtiles * ss, r.htiles * ss)
        assert r2.base == total
        total += num_mipmap_texels(r2)
    assert twin.num_texels == total

    # document why: the old density-loop construction mismatches on at
    # least one flagship wall (ADVICE r4 measured 5/172)
    if png.name == "example.png":
        mismatched = 0
        for r in scene.walls:
            rd = create_rect(r.pos, r.width, r.height, 200.0 * ss * ss)
            if (rd.wtiles, rd.htiles) != (r.wtiles * ss, r.htiles * ss):
                mismatched += 1
        assert mismatched > 0

    # non-power-of-two ss is rejected up front
    with pytest.raises(ValueError, match="power of two"):
        supersampled_scene(scene, 3, DEFAULT_CONFIG)


def test_render_supersample_end_to_end(tmp_path):
    """supersample=2: tiles export at the BASE grid, the supersampled twin
    scene really had 2x tiles per dimension, and the lightmap is finite
    and lit."""
    res = render(
        str(FIXTURES / "tiny.png"), str(tmp_path), 30.0,
        _cfg(Engine.PHOTON_XLA), supersample=2,
    )
    assert len(res.tile_paths) == len(res.scene.walls)
    for p, rect in zip(res.tile_paths, res.scene.walls):
        img = PILImage.open(p)
        assert img.size == (rect.wtiles, rect.htiles)
    assert np.isfinite(res.texels).all()
    assert res.texels.sum() > 0
    # same scene artifacts as the base render (ss touches only texels)
    assert (tmp_path / "geometry.json").read_text() == (
        FIXTURES / "tiny_geometry.json"
    ).read_text()


def test_texel_cap_refusal_flagship_density():
    """The 1 GB texel-arena cap (parseLayout.c:520-524, ported at
    layout.py) actually fires: both user paths that can blow the arena —
    a high --supersample factor on the flagship scene and a raised texel
    density — refuse BEFORE any allocation or render, with the projected
    size in the message."""
    from flatmatch.render import supersampled_scene
    from flatmatch.scene import image as im, layout
    from flatmatch.scene.rect_dump import load_rect_dump

    scene = load_rect_dump(FIXTURES / "example_rects.txt")
    # flagship at ss=32: 1024 x 114k texels x 16 B = 1.86 GB > 1 GB
    with pytest.raises(MemoryError, match="1.86 GB"):
        supersampled_scene(scene, 32, DEFAULT_CONFIG)

    # raised density through the scene compiler itself
    img = im.load_layout(str(FIXTURES / "mini.png"))
    with pytest.raises(MemoryError, match="cap 1.00 GB"):
        layout.parse_layout(
            img, np.float32(1.0) / np.float32(30.0), 200.0 * 16384
        )


def test_wide_engine_texel_id_guard():
    """Texel ids are int32 end to end: past 2^24, where an f32 id would
    round, the trace kernel's deposit ids still equal the XLA engine's
    exactly (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from flatmatch.config import PhotonConfig
    from flatmatch.engines import photon, photon_triton as pt
    from flatmatch.engines.schedule import emitter_slice
    from flatmatch.ops.aa_scene import pack_aa
    from flatmatch.ops.device_scene import pack_emitters, pack_rects
    from flatmatch.scene.rect_dump import load_rect_dump

    scene = load_rect_dump(FIXTURES / "tiny_rects.txt")
    shift = (1 << 24) + 1
    walls = [dataclasses.replace(r, base=r.base + shift) for r in scene.walls]
    cfg = PhotonConfig(photons_per_batch=512)
    em = emitter_slice(
        pack_emitters(scene, 1.0, cfg.window_color, cfg.light_color), 0
    )
    u = jax.random.uniform(jax.random.PRNGKey(3), (512, 28), jnp.float32)
    xi, _ = jax.jit(photon.trace_deposits, static_argnames=("cfg",))(
        pack_rects(walls), em, u, 512, cfg
    )
    aa = pack_aa(walls)
    ki, _ = pt.trace_deposits(
        aa.fields, aa.base, pt.emitter_vector(em), u, 512, cfg,
        pt.KernelSpec(aa.group_counts, interpret=True),
    )
    xi, ki = np.asarray(xi), np.asarray(ki)
    live = xi != photon.DEAD
    assert live.any() and (xi[live] > (1 << 24)).all()
    np.testing.assert_array_equal(ki, xi)


def test_cli_render_without_pillow(tmp_path):
    """The main path needs no imaging package: `cli render` with every
    import of PIL refused still writes the JSONs and the tiles."""
    import os
    import subprocess
    import sys

    repo = str(FIXTURES.parents[1])
    code = (
        "import sys\n"
        "class NoPIL:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'PIL' or name.startswith('PIL.'):\n"
        "            raise ImportError('PIL is blocked')\n"
        "sys.meta_path.insert(0, NoPIL())\n"
        "from flatmatch import cli\n"
        "rc = cli.main(sys.argv[1:])\n"
        "assert 'PIL' not in sys.modules\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", code, "render", str(FIXTURES / "tiny.png"),
         "30", "--samples-per-area", "2000", "--photons-per-batch", "512",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "geometry.json").read_text() == (
        FIXTURES / "tiny_geometry.json"
    ).read_text()
    assert len(list((tmp_path / "tiles").glob("tile_*.png"))) == 13
