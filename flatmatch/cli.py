"""Command-line interface.

  python -m flatmatch.cli render <layout.png> [scale] [options]
  python -m flatmatch.cli package <layout.png> <offer_id> <scale> \
         <lat> <lon> <yaw> <level> [options]

`render` is `./globalIllumination <png> [scale]`
(/root/reference/main.c:17-32); `package` is
`generate_flatmatch_entry.py` (generate_flatmatch_entry.py:10-20). Unlike the
reference, the engine and physics constants are selectable via flags instead
of requiring a recompile (README.md:16; SURVEY.md §5 Config).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import DEFAULT_CONFIG, Engine


def _add_engine_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--engine",
        choices=["auto"] + [e.value for e in Engine],
        default="auto",
        help="illumination engine (reference MODE enum, main.c:14); auto = "
        "the platform's default photon engine (the trace kernel on the "
        "GPU, photon_xla on the CPU)",
    )
    p.add_argument(
        "--samples-per-area",
        type=float,
        default=DEFAULT_CONFIG.photon.samples_per_area,
        help="photons per m^2 of emitter area (main.c:58)",
    )
    p.add_argument("--seed", type=int, default=DEFAULT_CONFIG.photon.seed)
    p.add_argument(
        "--photons-per-batch",
        type=int,
        default=DEFAULT_CONFIG.photon.photons_per_batch,
    )
    p.add_argument(
        "--device-rng",
        action=argparse.BooleanOptionalAction,
        # CLI default ON (measured faster on the card, PERF.md; the closest
        # analog of the reference kernel generating its uniforms
        # in-register, photonmap.cl:21-25). The library default (config.py)
        # stays off: the threefry tensor is what shares draws with the
        # oracle.
        default=True,
        help="trace kernel: generate uniforms in-kernel with a counter-hash "
        "PRNG (photonmap.cl:21-25 analog)",
    )
    p.add_argument(
        "--radiosity-rays",
        type=int,
        default=DEFAULT_CONFIG.radiosity.rays_per_texel,
        help="form-factor rays per texel (radiosityNative.c:147)",
    )
    p.add_argument(
        "--radiosity-iterations",
        type=int,
        default=DEFAULT_CONFIG.radiosity.iterations,
    )
    p.add_argument(
        "--ao-chunk",
        type=int,
        default=DEFAULT_CONFIG.ao.texels_per_chunk,
        help="AO texels per device dispatch",
    )
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument(
        "--checkpoint",
        default=None,
        metavar="PATH",
        help="checkpoint file for the photon engines; an interrupted render "
        "resumes bit-identically (utils/checkpoint.py)",
    )
    p.add_argument(
        "--checkpoint-every",
        type=int,
        default=DEFAULT_CONFIG.photon.checkpoint_every,
        metavar="BATCHES",
        help="checkpoint/segment granularity in photon batches (part of "
        "the resume fingerprint: a resume must use the same value)",
    )
    p.add_argument(
        "--single-device",
        action="store_true",
        help="disable the multi-device sharded engines even when more than "
        "one device is visible",
    )
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace of the render into DIR "
        "(view with TensorBoard / xprof; the reference's analog was "
        "compiled-out gcc PGO hooks, Makefile:22-24)",
    )
    # multi-host launch (same command on every host); with none of these
    # set, cluster auto-detection applies (parallel/multihost.py)
    p.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator address host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _build_cfg(args):
    engine = None if args.engine == "auto" else Engine(args.engine)
    cfg = DEFAULT_CONFIG.replace(engine=engine)
    return cfg.replace(
        photon=dataclasses.replace(
            cfg.photon,
            samples_per_area=args.samples_per_area,
            seed=args.seed,
            photons_per_batch=args.photons_per_batch,
            device_rng=args.device_rng,
            checkpoint_every=args.checkpoint_every,
        ),
        radiosity=dataclasses.replace(
            cfg.radiosity,
            rays_per_texel=args.radiosity_rays,
            iterations=args.radiosity_iterations,
            seed=args.seed,
        ),
        ao=dataclasses.replace(cfg.ao, texels_per_chunk=args.ao_chunk),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="flatmatch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render lightmap tiles")
    p_render.add_argument("layout", help="layout PNG path")
    p_render.add_argument(
        "scale", nargs="?", type=float, default=30.0, help="pixels per meter"
    )
    _add_engine_flags(p_render)
    p_render.add_argument(
        "--preview",
        action="store_true",
        help="photon engines: re-write tiles after every dispatch segment, "
        "exposure-scaled by traced-so-far fraction (the browser port's "
        "incremental lightmaps, worker.js:43-60)",
    )
    p_render.add_argument(
        "--dump-raw",
        action="store_true",
        help="also write tiles/tile_<i>.raw float32 dumps with TileMetadata "
        "headers (the reference's saveAsRaw, rectangle.c:391-429) — the "
        "target format for the `fit` command",
    )
    p_render.add_argument(
        "--dilate-seams",
        action="store_true",
        help="fill lit/unlit boundary texels with their brightest neighbor "
        "on export, so the viewer's bilinear filtering doesn't bleed dark "
        "seams (the dilation the reference prototyped in its dead "
        "imageProcessing.c but never shipped)",
    )
    p_render.add_argument(
        "--supersample",
        type=int,
        default=1,
        metavar="N",
        help="render at N^2 x the texel density and box-average non-zero "
        "sub-texels down before tone mapping (the reference's dead "
        "supersampled-tone hint, imageProcessing.c:145-184 — the other "
        "half of the --dilate-seams pair)",
    )

    p_fit = sub.add_parser(
        "fit",
        help="inverse rendering: fit per-wall albedo + per-emitter power "
        "so the photon render matches a target (render --dump-raw output)",
    )
    p_fit.add_argument("layout", help="layout PNG path")
    p_fit.add_argument(
        "target", help="directory containing tile_<i>.raw dumps "
        "(the tiles/ dir of a `render --dump-raw` run)"
    )
    p_fit.add_argument(
        "scale", nargs="?", type=float, default=30.0, help="pixels per meter"
    )
    _add_engine_flags(p_fit)
    p_fit.add_argument("--fit-steps", type=int, default=100)
    p_fit.add_argument("--fit-lr", type=float, default=0.1)
    p_fit.add_argument(
        "--fit-power-only", action="store_true",
        help="hold albedo at its init; fit emitter powers only",
    )
    p_fit.add_argument(
        "--fit-init-albedo", type=float, default=None,
        help="starting albedo (default: the physics constant 0.9)",
    )
    p_fit.add_argument(
        "--fit-render", default=None, metavar="DIR",
        help="also export tone-mapped tiles rendered at the fitted "
        "parameters into DIR",
    )
    p_fit.add_argument(
        "--fit-init-power", type=float, default=1.0,
        help="starting emitter power multiplier",
    )

    p_pkg = sub.add_parser("package", help="render + assemble REST tree")
    p_pkg.add_argument("layout")
    p_pkg.add_argument("offer_id", type=int)
    p_pkg.add_argument("scale", type=float)
    p_pkg.add_argument("latitude", type=float)
    p_pkg.add_argument("longitude", type=float)
    p_pkg.add_argument("yaw", type=float)
    p_pkg.add_argument("level", type=int)
    _add_engine_flags(p_pkg)

    p_srv = sub.add_parser(
        "serve",
        help="serve an assembled REST tree to the FlatMatch viewer "
        "(the consumer of generate_flatmatch_entry.py:54-82's layout)",
    )
    p_srv.add_argument(
        "root", nargs="?", default=".",
        help="directory containing rest/ (the package --out dir)",
    )
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000)

    p_dbg = sub.add_parser(
        "debug",
        help="first-hit debug render with per-rect index colors (the "
        "debugRaytracer.cc:108-200 harness as a command)",
    )
    p_dbg.add_argument("layout", help="layout PNG path")
    p_dbg.add_argument("scale", nargs="?", type=float, default=30.0)
    p_dbg.add_argument("--out", default="image.png",
                       help="output PNG (reference wrote image.png)")
    p_dbg.add_argument("--width", type=int, default=1024)
    p_dbg.add_argument("--height", type=int, default=768)
    p_dbg.add_argument("--pos", type=float, nargs=3, default=None,
                       metavar=("X", "Y", "Z"),
                       help="camera position in meters (default: the "
                       "scene's startingPosition at eye height)")
    p_dbg.add_argument("--dir", type=float, nargs=3, default=(1.0, 1.0, 0.0),
                       metavar=("DX", "DY", "DZ"), dest="direction")

    args = parser.parse_args(argv)

    if args.cmd == "debug":
        import numpy as _np

        from .debug.raytrace import Camera, render_first_hit
        from .io import png as _png
        from .ops.device_scene import pack_rects
        from .scene import geometry as _geo, image as _im, layout as _lay
        from .utils.progress import info

        img = _im.load_layout(args.layout)
        lay = _lay.parse_layout(
            img, _np.float32(1.0) / _np.float32(args.scale), 200.0
        )
        scene = _geo.Scene(lay)
        pos = args.pos if args.pos is not None else (
            lay.starting_position[0], lay.starting_position[1], 1.6
        )
        cam = Camera(
            position=tuple(pos), direction=tuple(args.direction),
            width=args.width, height=args.height,
        )
        rgba = render_first_hit(scene, pack_rects(scene.walls), cam)
        _png.write_png(args.out, rgba)
        info(f"wrote {args.out} ({args.width}x{args.height}, "
             f"{len(scene.walls)} rects)")
        return 0

    if args.cmd == "serve":
        from .io.rest import make_rest_server
        from .utils.progress import info

        srv = make_rest_server(args.root, args.host, args.port)
        info(f"serving {args.root}/rest on http://{args.host}:{srv.server_port}")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    cfg = _build_cfg(args)

    # must precede every other jax call (multihost.py NOTE)
    from .parallel import multihost

    multihost.initialize(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()

    mesh = None if args.single_device else "auto"

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if getattr(args, "profile", None):
        import jax

        profile_ctx = jax.profiler.trace(args.profile)

    if args.cmd == "render":
        from .render import render

        ss = args.supersample
        if ss < 1 or (ss & (ss - 1)):
            parser.error(
                f"--supersample must be a power of two >= 1, got {ss} "
                "(the scaled tile grids must keep the power-of-two mipmap "
                "invariant, rectangle.c:176-186)"
            )
        with profile_ctx:
            render(args.layout, args.out, args.scale, cfg, mesh=mesh,
                   checkpoint_path=args.checkpoint, preview=args.preview,
                   dump_raw=args.dump_raw, dilate_seams=args.dilate_seams,
                   supersample=args.supersample)
        return 0
    if args.cmd == "fit":
        import pathlib

        from .diff.fit import fit_layout
        from .parallel.mesh import photon_mesh
        from .utils.progress import info

        import jax as _jax

        fit_mesh = None
        if not args.single_device and _jax.device_count() > 1:
            fit_mesh = photon_mesh()
        from .backend import describe

        info(f"fitting on {describe()} with the replay-VJP renderer")
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        report = out / "fitted.json"
        with profile_ctx:
            res = fit_layout(
                args.layout, args.target, args.scale, cfg,
                mesh=fit_mesh, steps=args.fit_steps,
                learning_rate=args.fit_lr,
                fit_albedo=not args.fit_power_only,
                init_albedo=args.fit_init_albedo,
                init_power=args.fit_init_power,
                out_path=str(report) if multihost.is_primary() else None,
                render_out=(
                    args.fit_render if multihost.is_primary() else None
                ),
            )
        if multihost.is_primary():
            info(
                f"fit: loss {res.losses[0]:.3e} -> {res.losses[-1]:.3e} "
                f"over {args.fit_steps} steps; report {report}"
            )
        return 0
    if args.cmd == "package":
        from .io.rest import package_offer

        with profile_ctx:
            package_offer(
                args.layout,
                args.offer_id,
                args.scale,
                args.latitude,
                args.longitude,
                args.yaw,
                args.level,
                args.out,
                cfg,
                mesh=mesh,
                checkpoint_path=args.checkpoint,
            )
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
