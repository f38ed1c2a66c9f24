"""Top-level render pipeline driver.

Equivalent of the reference main() (/root/reference/main.c:17-101):
layout PNG -> collision map JSON -> scene compile -> geometry JSON -> chosen
illumination engine -> exposure normalization -> per-wall lightmap tiles.
All magic constants live in config.RenderConfig (SURVEY.md §5 Config).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

from .config import DEFAULT_CONFIG, Engine, RenderConfig
from .io import tiles as tiles_io
from .ops.device_scene import exposure_scale, pack_emitters, pack_rects
from .scene import collision, geometry, image as im, layout

f32 = np.float32


@dataclasses.dataclass
class RenderResult:
    scene: geometry.Scene
    texels: np.ndarray          # [num_texels, 3] float32, post-normalization
    tile_paths: list
    geometry_json: str
    collision_json: Optional[str] = None


def compile_scene(layout_png: str, scale: float, cfg: RenderConfig):
    """Layout PNG -> compiled scene + collision JSON (main.c:33-52)."""
    img = im.load_layout(layout_png)
    collision_json = collision.build_collision_map(img, cfg.scene)
    lay = layout.parse_layout(
        img, f32(1.0) / f32(scale), cfg.scene.tile_size, cfg.scene
    )
    return geometry.Scene(lay), collision_json


def supersampled_scene(
    scene: geometry.Scene, ss: int, cfg: RenderConfig
) -> geometry.Scene:
    """Twin of `scene` whose wall tile grids are exactly ss x in each
    dimension, with the texel arena re-laid-out to match.

    The grids are scaled directly (wtiles/htiles *= ss) rather than by
    re-running the power-of-two density loop (rectangle.c:15-57) at
    ss^2 x density: the sizing loop doubles whichever dimension has the
    lower linear resolution, so for elongated walls it can spend all ss^2
    doublings on one axis (e.g. 1x32 -> 1x128 instead of 2x64), which
    breaks the ss x ss box-average. ss must be a power of two so the
    scaled grids keep the power-of-two mipmap invariant
    (rectangle.c:176-186). Emitters and the box hull are shared with the
    base scene (the photon engines only read them)."""
    from .scene.rectangle import num_mipmap_texels

    if ss < 1 or (ss & (ss - 1)):
        raise ValueError(f"supersample must be a power of two >= 1, got {ss}")
    lay = scene.layout
    walls = []
    total = 0
    for r in lay.walls:
        r2 = dataclasses.replace(
            r, wtiles=r.wtiles * ss, htiles=r.htiles * ss, base=total
        )
        total += num_mipmap_texels(r2)
        walls.append(r2)
    # same 1 GB arena cap as the scene compiler (parseLayout.c:520-524)
    layout.check_texel_cap(total, cfg.scene, context=f"supersample={ss}: ")
    lay2 = dataclasses.replace(lay, walls=walls, num_texels=total)
    return geometry.Scene(lay2)


def downsample_supersampled(
    scene, scene_ss, texels_ss: np.ndarray, ss: int
) -> np.ndarray:
    """Box-average an ss x-supersampled render down to `scene`'s texel grid.

    The design hint is the reference's dead supersampled tone conversion
    (/root/reference/imageProcessing.c:145-184,
    subsampleAndConvertToPerceptive): average each output texel's ss*ss
    sub-texel block EXCLUDING all-zero sub-texels (unlit seam texels would
    otherwise darken every lightmap edge), then tone-map the average. The
    averaging happens here on the pre-tonemap radiance; the usual tile
    export tone-maps the result."""
    from .scene.rectangle import num_tiles

    out = np.zeros((scene.num_texels, 3), np.float32)
    for r, r2 in zip(scene.walls, scene_ss.walls):
        if (r2.wtiles, r2.htiles) != (r.wtiles * ss, r.htiles * ss):
            raise ValueError(
                f"supersample={ss}: wall tile grid {r.wtiles}x{r.htiles} "
                f"did not scale to {r2.wtiles}x{r2.htiles}"
            )
        block = texels_ss[r2.base : r2.base + num_tiles(r2)].reshape(
            r.htiles, ss, r.wtiles, ss, 3
        )
        # the reference counts a sub-texel only when EVERY channel is
        # non-zero (imageProcessing.c:160-166)
        lit = np.all(block != 0.0, axis=-1, keepdims=True)
        count = lit.sum(axis=(1, 3))
        total = np.where(lit, block, 0.0).sum(axis=(1, 3))
        avg = np.divide(
            total, count, out=np.zeros_like(total), where=count > 0
        )
        out[r.base : r.base + num_tiles(r)] = avg.reshape(-1, 3)
    return out


def _auto_mesh():
    """The production photon mesh: all global devices, or None single-device.

    In the reference the device dispatch IS the pipeline
    (main.c:63 -> global_illumination_cl.c:275-313); here the pipeline
    auto-selects the sharded engines whenever more than one device is
    visible, so a multi-card launch scales without any code change."""
    import jax

    if jax.device_count() > 1:
        from .parallel.mesh import photon_mesh

        return photon_mesh()
    return None


def run_engine(
    scene: geometry.Scene, cfg: RenderConfig, mesh="auto",
    checkpoint_path: Optional[str] = None,
    on_segment=None,
) -> np.ndarray:
    """Dispatch the configured illumination engine (main.c:60-66) and apply
    photon exposure normalization where the reference does (main.c:68-79).

    `cfg.engine` None runs the platform's default photon engine
    (backend.choose_engine). `mesh`: "auto" shards the photon and radiosity
    engines over all visible devices when there is more than one; None
    forces single-device; an explicit jax.sharding.Mesh pins the device set.

    `on_segment(raw_lightmap, photons_done, photons_total)`: photon engines
    only — fires after every dispatch segment with the un-normalized
    accumulator (progressive-preview hook, engines/schedule.py)."""
    from .backend import choose_engine

    engine = choose_engine(cfg.engine)
    if mesh == "auto":
        mesh = _auto_mesh()
    if engine in (Engine.PHOTON_XLA, Engine.PHOTON_PALLAS):
        from .engines import schedule

        rects = pack_rects(scene.walls)
        emitters = pack_emitters(
            scene,
            cfg.photon.samples_per_area,
            cfg.photon.window_color,
            cfg.photon.light_color,
        )
        kernel = aa = None
        if engine is Engine.PHOTON_PALLAS:
            from .engines.photon_triton import KernelSpec
            from .ops.aa_scene import pack_aa

            aa = pack_aa(scene.walls)
            if aa is None:
                raise ValueError(
                    "engine photon_pallas needs an axis-aligned scene; this "
                    "one has tilted rects (use --engine photon_xla)"
                )
            kernel = KernelSpec(aa.group_counts)
        if mesh is not None:
            from .parallel import mesh as pmesh
            from .utils.progress import info

            info(f"sharded {engine.value} engine over "
                 f"{mesh.shape['photons']} devices")
            lightmap = pmesh.render_photons_sharded(
                rects, emitters, scene.num_texels, cfg.photon, mesh,
                checkpoint_path=checkpoint_path, on_segment=on_segment,
                kernel=kernel, aa=aa,
            )
        else:
            lightmap = schedule.render_photons(
                rects, emitters, scene.num_texels, cfg.photon,
                checkpoint_path=checkpoint_path, on_segment=on_segment,
                kernel=kernel, aa=aa,
            )
        scale = exposure_scale(
            scene, cfg.photon.samples_per_area, cfg.photon.exposure
        )
        return np.asarray(lightmap) * scale[:, None]
    if engine is Engine.PHOTON_ORACLE:
        from .engines import photon_oracle_driver

        lightmap = photon_oracle_driver.render_photons_np(scene, cfg.photon)
        scale = exposure_scale(
            scene, cfg.photon.samples_per_area, cfg.photon.exposure
        )
        return lightmap * scale[:, None]
    if engine is Engine.AMBIENT_OCCLUSION:
        from .engines import ao

        return ao.render_ao(scene, pack_rects(scene.walls), cfg.ao)
    if engine is Engine.RADIOSITY:
        from .engines import radiosity

        if mesh is not None:
            from .utils.progress import info

            info(f"sharded radiosity engine over {mesh.shape['photons']} "
                 f"devices (ray axis)")
            return radiosity.render_radiosity_sharded(
                scene, cfg.radiosity, mesh
            )
        return radiosity.render_radiosity(scene, cfg.radiosity)
    raise ValueError(f"unknown engine {engine}")


def render(
    layout_png: str,
    out_dir: str = ".",
    scale: float = 30.0,
    cfg: Optional[RenderConfig] = None,
    mesh="auto",
    checkpoint_path: Optional[str] = None,
    preview: bool = False,
    dump_raw: bool = False,
    dilate_seams: bool = False,
    supersample: int = 1,
) -> RenderResult:
    """Full pipeline: `./globalIllumination <png> <scale>`.

    Compiles the layout (writing collisionMap.json), then runs
    render_scene on the compiled scene; see render_scene for the options.

    Multi-host aware: every process compiles the scene and participates in
    the (sharded) engine collectives, but only the primary process writes
    artifacts (collision/geometry JSON, tiles)."""
    from .parallel import multihost

    cfg = cfg or DEFAULT_CONFIG
    scene, collision_json = compile_scene(layout_png, scale, cfg)
    if multihost.is_primary():
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "collisionMap.json").write_text(collision_json)
    res = render_scene(
        scene, out_dir, cfg, mesh=mesh, checkpoint_path=checkpoint_path,
        preview=preview, dump_raw=dump_raw, dilate_seams=dilate_seams,
        supersample=supersample,
    )
    res.collision_json = collision_json
    return res


def render_scene(
    scene: geometry.Scene,
    out_dir: str = ".",
    cfg: Optional[RenderConfig] = None,
    mesh="auto",
    checkpoint_path: Optional[str] = None,
    preview: bool = False,
    dump_raw: bool = False,
    dilate_seams: bool = False,
    supersample: int = 1,
) -> RenderResult:
    """The pipeline from a compiled scene (main.c:53-95): geometry.json,
    the chosen illumination engine, exposure normalization, lightmap tiles.

    `dump_raw=True` additionally writes tiles/tile_<i>.raw float32 dumps
    with TileMetadata headers (the reference's saveAsRaw artifact,
    rectangle.c:391-429, commented out at its call site main.c:94) — the
    input format of the `fit` inverse-rendering command.

    `preview=True` (photon engines): re-write the output tiles after every
    dispatch segment, exposure-scaled by the traced-so-far fraction so
    brightness is final from the first preview and noise converges — the
    analog of the reference browser port posting each wall's lightmap
    incrementally (/root/reference/worker.js:43-60).

    `supersample=N` (N > 1, photon engines): render at N^2 x the texel
    density and box-average non-zero sub-texels down to the configured
    grid before tone mapping — the reference's dead supersampled-tone
    design hint done right (imageProcessing.c:145-184; the other half of
    the pair whose dilation shipped as --dilate-seams)."""
    from .backend import choose_engine, describe
    from .parallel import multihost

    cfg = cfg or DEFAULT_CONFIG
    cfg = cfg.replace(engine=choose_engine(cfg.engine))
    primary = multihost.is_primary()
    out = pathlib.Path(out_dir)
    if primary:
        out.mkdir(parents=True, exist_ok=True)

    geo_json = geometry.geometry_json(scene)
    if primary:
        (out / "geometry.json").write_text(geo_json)

    lay = scene.layout
    if primary:
        print(
            f"[INF] Layout consists of {len(lay.walls)} walls "
            f"({scene.num_texels / 1000.0:.2f}k texels) "
            f"{len(lay.windows)} windows, {len(lay.lights)} lights"
        )
        print(f"[INF] rendering on {describe()} with engine "
              f"{cfg.engine.value}")

    # tintExtra for every mode except the CL-equivalent photon paths
    # (main.c:88-91)
    tint_extra = cfg.engine in (
        Engine.AMBIENT_OCCLUSION,
        Engine.PHOTON_ORACLE,
        Engine.RADIOSITY,
    )

    on_segment = None
    photon_engine = cfg.engine in (Engine.PHOTON_XLA, Engine.PHOTON_PALLAS)
    ss = int(supersample)
    if ss > 1 and preview:
        from .utils.progress import warn

        warn("--preview is unsupported with --supersample; ignored")
        preview = False
    if preview and photon_engine and primary:
        full_scale = exposure_scale(
            scene, cfg.photon.samples_per_area, cfg.photon.exposure
        )

        def on_segment(raw_lm, done, total):
            # scale the partial accumulator as if `done` were the full
            # budget: correct brightness immediately, noise converges
            part = np.asarray(raw_lm) * (
                full_scale[:, None] * (total / max(done, 1))
            )
            tiles_io.save_tiles(
                scene.walls, part, str(out / "tiles"), tint_extra,
                dilate_seams,
            )
            print(f"[INF] preview tiles at {done}/{total} photons")
    elif preview and not photon_engine and primary:
        from .utils.progress import warn

        warn("--preview applies to the photon engines only; ignored")

    if ss > 1:
        # render on the ss x ss-grid twin (its own exposure normalization
        # is self-consistent: ss^2 x numTiles cancels ss^2 x fewer photons
        # per texel, main.c:73-77), then box-average down
        scene_ss = supersampled_scene(scene, ss, cfg)
        texels_ss = run_engine(scene_ss, cfg, mesh, checkpoint_path)
        texels = downsample_supersampled(scene, scene_ss, texels_ss, ss)
    else:
        texels = run_engine(scene, cfg, mesh, checkpoint_path, on_segment)
    tile_paths = []
    if primary:
        tile_paths = tiles_io.save_tiles(
            scene.walls, texels, str(out / "tiles"), tint_extra,
            dilate_seams,
        )
        if dump_raw:
            for i, r in enumerate(scene.walls):
                tiles_io.save_tile_raw(
                    r, texels, str(out / "tiles" / f"tile_{i}.raw")
                )
    return RenderResult(
        scene=scene,
        texels=texels,
        tile_paths=tile_paths,
        geometry_json=geo_json,
    )
