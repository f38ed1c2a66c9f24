#!/usr/bin/env python3
"""On-card smoke test: the renderer's main paths on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Every phase runs in this one process (a JAX process reserves most of a
card's memory, so a second process on the card would fail) and compares
what it computes with the repository's references: the reference C
engine's golden dumps in tests/fixtures/, the plain XLA engine, or finite
differences. A phase that fails raises; nothing is caught. The script asks
JAX for the CUDA platform and exits non-zero, printing no result, when
there is no GPU or when the repository is not beside it.

Phases (one card):
  1. PNG entry: `cli render tests/fixtures/mini.png 30` with the default
     engine; geometry/collision JSON byte-equal to the fixtures.
  2. The flagship scene (tests/fixtures/example_rects.txt: 172 walls,
     113,964 texels) at the production budget, 1e8 photons/m^2.
  3. Photon engines vs the reference engine's dump at 3e5 photons/m^2;
     trace kernel vs photon_xla; per-deposit agreement on shared draws.
  4. Ambient occlusion vs the reference dump.
  5. Radiosity vs the reference dumps at 2000 and 10000 rays per texel.
  6. Inverse rendering: fit steps on mini; replay-VJP gradient vs finite
     differences.
  7. Trace kernel vs photon_xla, whole flagship schedule: times, a
     launch (block and warps) A/B, the default engine checked against the
     winner; the deposit scatter with dead deposits dropped or not.

Four cards: two processes of the CLI sharing the host's cards against one
process on all four, then the sharded photon render, sharded radiosity and
a sharded gradient against one card.

The last line of output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
FIX = REPO / "tests" / "fixtures"
FLAGSHIP = FIX / "example_rects.txt"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value, bound: str, ok: bool) -> None:
    """Print a comparison with its tolerance; raise if it fails."""
    log(f"  {name}: {value}  (bound {bound})  {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value} violates {bound}")


def timed(fn, runs: int = 3):
    """(median seconds of `runs` warm calls, last result); one warm-up."""
    import jax

    jax.block_until_ready(fn())
    ts, out = [], None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def golden(name: str, num_texels: int):
    import numpy as np

    raw = np.fromfile(FIX / name, dtype="<f4")
    return raw.reshape(num_texels, 4)[:, :3]


def compare_photon(label, ours, gold, scene, min_walls=20):
    """The bounds of tests/test_physics_vs_reference.py: total energy 2%,
    per-wall mean radiance 12% (25% below 64 texels) on lit walls, texel
    correlation > 0.98."""
    import numpy as np

    from flatmatch.scene.rectangle import num_tiles

    rel = abs(float(ours.sum()) / float(gold.sum()) - 1.0)
    check(f"{label} energy rel err", f"{rel:.3e}", "< 0.02", rel < 0.02)
    worst, checked = 0.0, 0
    for r in scene.walls:
        sl = slice(r.base, r.base + num_tiles(r))
        g = gold[sl].mean()
        if g > gold.sum() / scene.num_texels * 0.1:
            tol = 0.12 if num_tiles(r) >= 64 else 0.25
            worst = max(worst, abs(ours[sl].mean() - g) / g / tol)
            checked += 1
    check(f"{label} worst wall mean / its tolerance (12%|25%) over "
          f"{checked} walls", f"{worst:.3f}", "< 1", worst < 1.0)
    check(f"{label} walls checked", checked, f">= {min_walls}",
          checked >= min_walls)
    corr = float(np.corrcoef(ours.ravel(), gold.ravel())[0, 1])
    check(f"{label} texel correlation", f"{corr:.5f}", "> 0.98",
          corr > 0.98)


def phase_png_entry(tmp):
    from flatmatch import cli
    from flatmatch.io import png, tiles as tiles_io
    import numpy as np

    out = tmp / "mini"
    t0 = time.perf_counter()
    rc = cli.main(["render", str(FIX / "mini.png"), "30", "--out", str(out),
                   "--dump-raw"])
    log(f"  cli render mini.png: exit {rc} in {time.perf_counter() - t0:.2f} s")
    check("cli exit code", rc, "== 0", rc == 0)
    for name in ("geometry.json", "collisionMap.json"):
        same = (out / name).read_bytes() == (
            FIX / f"mini_{name}"
        ).read_bytes()
        check(f"{name} byte-equal to tests/fixtures/mini_{name}", same,
              "True", same)
    tiles = sorted((out / "tiles").glob("tile_*.png"))
    raws = sorted((out / "tiles").glob("tile_*.raw"))
    check("tiles written", len(tiles), "== 27 walls", len(tiles) == 27)
    finite = all(np.isfinite(tiles_io.load_tile_raw(str(p))[1]).all()
                 for p in raws)
    lit = sum(int(png.read_png(p)[..., :3].max() > 0) for p in tiles)
    check("raw tiles finite", finite, "True", finite and len(raws) == 27)
    check("lit tiles", lit, ">= 20 of 27", lit >= 20)


def phase_flagship(tmp):
    import numpy as np

    from flatmatch.config import DEFAULT_CONFIG
    from flatmatch.ops.device_scene import pack_emitters
    from flatmatch.render import render_scene
    from flatmatch.scene.rect_dump import load_rect_dump

    scene = load_rect_dump(FLAGSHIP)
    cfg = DEFAULT_CONFIG
    n = int(pack_emitters(scene, cfg.photon.samples_per_area,
                          cfg.photon.window_color,
                          cfg.photon.light_color).counts.sum())
    log(f"  flagship: {len(scene.walls)} walls, {len(scene.windows)} "
        f"windows, {len(scene.lights)} lights, {scene.num_texels} texels; "
        f"{n} photons at {cfg.photon.samples_per_area:g} photons/m^2")
    for run in ("first (compiles)", "second"):
        t0 = time.perf_counter()
        res = render_scene(scene, str(tmp / "flagship"), cfg, mesh=None)
        dt = time.perf_counter() - t0
        log(f"  {run} render_scene: {dt:.3f} s, {n / dt:.4g} photons/s "
            f"end to end (tiles included)")
    check("texels finite", bool(np.isfinite(res.texels).all()), "True",
          bool(np.isfinite(res.texels).all()))
    check("tiles written", len(res.tile_paths), "== 172",
          len(res.tile_paths) == 172)
    return scene


def phase_photon_reference(scene):
    import jax
    import numpy as np

    from flatmatch.config import DEFAULT_CONFIG, Engine, PhotonConfig
    from flatmatch.engines import photon, photon_triton
    from flatmatch.engines.schedule import emitter_slice
    from flatmatch.ops.aa_scene import pack_aa
    from flatmatch.ops.device_scene import (
        exposure_scale, pack_emitters, pack_rects,
    )
    from flatmatch.render import run_engine

    gold = golden("example_photon_native_spa300k.f32", scene.num_texels)
    pcfg = PhotonConfig(samples_per_area=300000.0, photons_per_batch=65536,
                        seed=3)
    # run_engine normalizes exposure (main.c:68-79); the dumps are raw sums
    es = exposure_scale(scene, pcfg.samples_per_area, pcfg.exposure)
    lit = es > 0
    raw = {}
    for engine in (Engine.PHOTON_PALLAS, Engine.PHOTON_XLA):
        cfg = DEFAULT_CONFIG.replace(engine=engine, photon=pcfg)
        lm = run_engine(scene, cfg, mesh=None)
        raw[engine] = np.zeros_like(lm)
        raw[engine][lit] = lm[lit] / es[lit, None]
        compare_photon(engine.value + " vs reference engine", raw[engine],
                       gold, scene)
    compare_photon("photon_pallas vs photon_xla", raw[Engine.PHOTON_PALLAS],
                   raw[Engine.PHOTON_XLA], scene)

    # one batch on shared threefry draws: per-deposit texel agreement
    cfg = PhotonConfig()
    B = cfg.photons_per_batch
    rects = pack_rects(scene.walls)
    ems = pack_emitters(scene, 1.0, cfg.window_color, cfg.light_color)
    aa = pack_aa(scene.walls)
    em = emitter_slice(ems, 0)
    u = jax.random.uniform(jax.random.PRNGKey(11),
                           (B, photon.uniforms_per_photon(cfg.max_depth)))
    xi, xc = jax.jit(photon.trace_deposits, static_argnames=("cfg",))(
        rects, em, u, B, cfg)
    ki, kc = photon_triton.trace_deposits(
        aa.fields, aa.base, photon_triton.emitter_vector(em), u, B, cfg,
        photon_triton.KernelSpec(aa.group_counts))
    xi, ki = np.asarray(xi), np.asarray(ki)
    both = (xi != photon.DEAD) & (ki != photon.DEAD)
    agree = float((xi == ki)[both].mean())
    live = float((ki != photon.DEAD).mean()) - float(
        (xi != photon.DEAD).mean())
    check("share of live deposits whose texel agrees (kernel vs XLA, "
          "same draws)", f"{agree:.6f}", ">= 0.99", agree >= 0.99)
    check("live-deposit share difference", f"{live:.2e}", "|.| < 1e-3",
          abs(live) < 1e-3)
    e_rel = abs(float(np.asarray(kc).sum()) / float(np.asarray(xc).sum())
                - 1.0)
    check("batch deposit energy rel diff", f"{e_rel:.3e}", "< 1e-3",
          e_rel < 1e-3)


def phase_ao(scene):
    import numpy as np

    from flatmatch.config import AoConfig
    from flatmatch.engines import ao
    from flatmatch.ops.device_scene import pack_rects
    from flatmatch.scene.rectangle import num_tiles

    gold = golden("example_ao_texels.f32", scene.num_texels)
    t0 = time.perf_counter()
    ours = np.asarray(ao.render_ao(scene, pack_rects(scene.walls),
                                   AoConfig()))
    log(f"  AO flagship: {time.perf_counter() - t0:.2f} s")
    level0 = scene.level0_mask()
    a, g = ours[level0], gold[level0]
    rel = np.abs(a - g) / np.maximum(np.abs(g), 1e-6)
    check("AO mean rel err", f"{rel.mean():.3e}", "< 2e-4",
          rel.mean() < 2e-4)
    bad = float((rel.max(axis=1) >= 5e-4).mean())
    check("AO share of texels with rel err >= 5e-4", f"{bad:.4f}",
          "<= 0.02", bad <= 0.02)
    check("AO mipmap slots zero", bool((ours[~level0] == 0).all()), "True",
          bool((ours[~level0] == 0).all()))
    # the flagship wall subset of tests/test_ao_parity.py (no knife-edge
    # ties against the reference)
    for wi in (147, 164, 38, 88, 154):
        r = scene.walls[wi]
        sl = slice(r.base, r.base + num_tiles(r))
        m = float((np.abs(ours[sl] - gold[sl])
                   / np.maximum(np.abs(gold[sl]), 1e-6)).max())
        check(f"AO wall {wi} max rel err", f"{m:.3e}", "< 1e-4", m < 1e-4)


def compare_radiosity(label, ours, gold, scene, energy, wall_rtol, corr_min,
                      worst_max=None):
    import numpy as np

    from flatmatch.scene.rectangle import num_tiles

    rel = abs(float(ours.sum()) / float(gold.sum()) - 1.0)
    check(f"{label} energy rel err", f"{rel:.3e}", f"< {energy}",
          rel < energy)
    worst, checked = 0.0, 0
    for r in scene.walls:
        sl = slice(r.base, r.base + num_tiles(r))
        g = gold[sl].mean()
        if g > 1e-3:
            err = abs(ours[sl].mean() - g) / g
            if worst_max is None:  # in units of the wall's tolerance
                err /= wall_rtol(num_tiles(r))
            worst = max(worst, err)
            checked += 1
    bound = "< 1 (tolerance units)" if worst_max is None else f"< {worst_max}"
    check(f"{label} worst wall-mean err over {checked} walls",
          f"{worst:.3e}", bound,
          worst < (1.0 if worst_max is None else worst_max))
    corr = float(np.corrcoef(ours.ravel(), gold.ravel())[0, 1])
    check(f"{label} texel correlation", f"{corr:.6f}", f"> {corr_min}",
          corr > corr_min)


def phase_radiosity(scene):
    from flatmatch.config import RadiosityConfig
    from flatmatch.engines import radiosity

    for rays, fixture in ((2000, "example_radiosity_rays2000.f32"),
                          (10000, "example_radiosity_rays10000.f32")):
        cfg = RadiosityConfig(rays_per_texel=rays, iterations=7, seed=5)
        t0 = time.perf_counter()
        ours = radiosity.render_radiosity(scene, cfg)
        log(f"  radiosity rays={rays}: {time.perf_counter() - t0:.2f} s "
            f"(compile included)")
        gold = golden(fixture, scene.num_texels)
        if rays == 2000:
            # tests/test_radiosity_vs_reference.py
            compare_radiosity(f"radiosity rays={rays}", ours, gold, scene,
                              0.02, lambda t: 0.08 if t >= 64 else 0.2,
                              0.99)
        else:
            # the production-budget gate's bounds
            compare_radiosity(f"radiosity rays={rays}", ours, gold, scene,
                              0.01, None, 0.995, worst_max=0.1)


def phase_inverse(tmp):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flatmatch import cli
    from flatmatch.config import DEFAULT_CONFIG, Engine, PhotonConfig
    from flatmatch.diff.fit import fit_layout
    from flatmatch.diff.render import make_diff_renderer
    from flatmatch.ops.device_scene import pack_emitters, pack_rects
    from flatmatch.scene.rect_dump import load_rect_dump

    spa = 20000.0
    target = tmp / "fit_target"
    rc = cli.main(["render", str(FIX / "mini.png"), "30", "--out",
                   str(target), "--engine", "photon_xla", "--dump-raw",
                   "--samples-per-area", str(spa), "--photons-per-batch",
                   "8192"])
    check("target render exit code", rc, "== 0", rc == 0)
    pcfg = PhotonConfig(samples_per_area=spa, photons_per_batch=8192)
    cfg = DEFAULT_CONFIG.replace(engine=Engine.PHOTON_XLA, photon=pcfg)
    t0 = time.perf_counter()
    res = fit_layout(str(FIX / "mini.png"), str(target / "tiles"), 30.0,
                     cfg, steps=8, learning_rate=0.1, init_albedo=0.6,
                     init_power=0.7)
    log(f"  fit_layout 8 steps: {time.perf_counter() - t0:.2f} s, losses "
        f"{[f'{v:.3e}' for v in res.losses]}")
    check("fit loss falls", f"{res.losses[0]:.3e} -> {res.losses[-1]:.3e}",
          "last < first / 2", res.losses[-1] < res.losses[0] / 2)

    scene = load_rect_dump(FIX / "mini_rects.txt")
    rects = pack_rects(scene.walls)
    ems = pack_emitters(scene, spa, pcfg.window_color, pcfg.light_color)
    render = make_diff_renderer(rects, ems, scene.num_texels, pcfg)
    a0 = jnp.full((rects.pos.shape[0],), pcfg.albedo, jnp.float32)
    p0 = jnp.ones((ems.pos.shape[0],), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(0), (scene.num_texels, 3)) ** 2

    def loss(a, p):
        return jnp.sum(render(a, p) * w)

    ga, gp = jax.grad(loss, argnums=(0, 1))(a0, p0)
    ga, gp = np.asarray(ga), np.asarray(gp)
    fin = bool(np.isfinite(ga).all() and np.isfinite(gp).all())
    check("replay-VJP gradients finite", fin, "True", fin)
    h = 1e-2
    i = int(np.argmax(np.abs(ga)))
    fd = (float(loss(a0.at[i].add(h), p0))
          - float(loss(a0.at[i].add(-h), p0))) / (2 * h)
    rel = abs(ga[i] / fd - 1.0)
    check(f"d loss / d albedo[{i}] vs central difference",
          f"{ga[i]:.5e} vs {fd:.5e} (rel {rel:.2e})", "rel < 5e-2",
          rel < 5e-2)
    fd = (float(loss(a0, p0.at[0].add(h)))
          - float(loss(a0, p0.at[0].add(-h)))) / (2 * h)
    rel = abs(gp[0] / fd - 1.0)
    check("d loss / d power[0] vs central difference",
          f"{gp[0]:.5e} vs {fd:.5e} (rel {rel:.2e})", "rel < 5e-2",
          rel < 5e-2)


def phase_kernel_vs_xla(scene):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from flatmatch.backend import DEFAULT_PHOTON_ENGINE
    from flatmatch.config import Engine, PhotonConfig
    from flatmatch.engines import photon, photon_triton, schedule
    from flatmatch.ops import splat
    from flatmatch.ops.aa_scene import pack_aa
    from flatmatch.ops.device_scene import pack_emitters, pack_rects

    probe = pack_emitters(scene, 1.0, (18, 18, 18), (16, 16, 18))
    spa = (1 << 28) / float(np.asarray(probe.area).sum())
    cfg = PhotonConfig(samples_per_area=spa)
    rects = pack_rects(scene.walls)
    ems = pack_emitters(scene, spa, cfg.window_color, cfg.light_color)
    aa = pack_aa(scene.walls)
    n = int(ems.counts.sum())
    log(f"  whole schedule: {n} photons, batch {cfg.photons_per_batch}, "
        f"median of 3 warm runs")

    def render(c, kernel=None):
        return lambda: schedule.render_photons(
            rects, ems, scene.num_texels, c, kernel=kernel, aa=aa)

    spec = photon_triton.KernelSpec(aa.group_counts)
    t_xla, lm_xla = timed(render(cfg))
    t_k, lm_k = timed(render(cfg, spec))
    t_kr, lm_kr = timed(render(dataclasses.replace(cfg, device_rng=True),
                               spec))
    for name, t in (("photon_xla", t_xla),
                    (f"photon_pallas threefry block={spec.block} "
                     f"warps={spec.num_warps}", t_k),
                    ("photon_pallas device_rng", t_kr)):
        log(f"  {name}: {t:.4f} s, {n / t / 1e6:.2f} Mphotons/s")
    for name, lm in (("threefry", lm_k), ("device_rng", lm_kr)):
        rel = abs(float(np.asarray(lm).sum()) / float(np.asarray(
            lm_xla).sum()) - 1.0)
        check(f"kernel ({name}) energy vs photon_xla", f"{rel:.3e}",
              "< 1e-3", rel < 1e-3)

    # launch A/B on the whole schedule, runs interleaved so drift in the
    # card's clocks falls on every launch alike
    launches = [(64, 1), (128, 1), (256, 2), (256, 4)]
    runs = {}
    for rng in (False, True):
        c = dataclasses.replace(cfg, device_rng=rng)
        for block, warps in launches:
            s = photon_triton.KernelSpec(aa.group_counts, block=block,
                                         num_warps=warps)
            runs[rng, block, warps] = (render(c, s), [])
            jax.block_until_ready(runs[rng, block, warps][0]())
    order = list(runs) + list(runs)[::-1]
    for _ in range(3):
        for k in order:
            t0 = time.perf_counter()
            jax.block_until_ready(runs[k][0]())
            runs[k][1].append(time.perf_counter() - t0)
    for (rng, block, warps), (_, ts) in runs.items():
        t = statistics.median(ts)
        default = (block, warps) == (spec.block, spec.num_warps)
        log(f"  launch block={block} warps={warps} "
            f"{'device_rng' if rng else 'threefry'}: median of {len(ts)} "
            f"{t:.4f} s, {n / t / 1e6:.2f} Mphotons/s"
            f"{'  (default)' if default else ''}")

    # scatter of one batch's deposit stream: dead deposits dropped (the
    # engines' out-of-range id) against all of them added to texel 0
    B = cfg.photons_per_batch
    ev = photon_triton.emitter_vector(
        photon.EmitterSlice(*(x[0] for x in (ems.pos, ems.wvec, ems.hvec,
                                             ems.n, ems.color,
                                             ems.is_window))))
    idx, col = photon_triton.trace_deposits_rng(
        aa.fields, aa.base, ev, 7, B, B, cfg, spec)
    on_zero = jnp.where(idx == photon.DEAD, 0, idx)
    lm0 = jnp.zeros((scene.num_texels, 3), jnp.float32)
    scatter = jax.jit(splat.scatter_splat)
    t_drop, a = timed(lambda: scatter(lm0, idx, col), runs=7)
    t_zero, b = timed(lambda: scatter(lm0, on_zero, col), runs=7)
    dead = float(np.asarray(idx == photon.DEAD).mean())
    log(f"  scatter of {idx.size} deposits ({dead:.1%} dead), median of 7: "
        f"dead dropped {t_drop * 1e3:.3f} ms, dead on texel 0 "
        f"{t_zero * 1e3:.3f} ms")
    rel = abs(float(a.sum()) / float(b.sum()) - 1.0)
    check("scatter energy, dropped vs texel 0", f"{rel:.3e}", "< 1e-5",
          rel < 1e-5)
    faster = (Engine.PHOTON_PALLAS if min(t_k, t_kr) < t_xla
              else Engine.PHOTON_XLA)
    check("default GPU photon engine is the faster one",
          DEFAULT_PHOTON_ENGINE["gpu"].value, f"== {faster.value}",
          DEFAULT_PHOTON_ENGINE["gpu"] is faster)


# the shared-host launch renders mini.png with these arguments
SHARED_HOST_ARGS = ["render", str(FIX / "mini.png"), "30", "--dump-raw",
                    "--samples-per-area", "1e7"]


def launch_shared_host(tmp):
    """Two CLI processes on this host, started before this process opens
    a card: each must take two of the four cards (parallel/multihost.py),
    or the second would find no memory left."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, JAX_PLATFORMS="cuda",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flatmatch.cli", *SHARED_HOST_ARGS, "--out",
         str(tmp / "shared_host"), "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(pid)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    ) for pid in range(2)]
    t0 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"  two processes, mini.png: {time.perf_counter() - t0:.1f} s "
        f"(start-up and compiles included)")
    for pid, (p, out) in enumerate(zip(procs, logs)):
        up = [line for line in out.splitlines() if "runtime up" in line]
        log(f"  process {pid}: exit {p.returncode}; {up}")
        if p.returncode != 0:
            log(out[-4000:])
        check(f"process {pid} exit code", p.returncode, "== 0",
              p.returncode == 0)
        check(f"process {pid} cards", up, "'2 local / 4 global devices'",
              any("2 local / 4 global devices" in line for line in up))


def raw_tiles(out):
    """A render's --dump-raw tiles, in tile order, as one [N, 3] array."""
    import numpy as np

    from flatmatch.io import tiles as tiles_io

    raws = sorted((out / "tiles").glob("tile_*.raw"))
    return np.concatenate([tiles_io.load_tile_raw(str(p))[1].reshape(-1, 3)
                           for p in raws])


def four_cards(tmp):
    """The shared-host launch against one process on every card, then the
    sharded paths against one card, statistically."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flatmatch import cli

    from flatmatch.config import (
        DEFAULT_CONFIG, PhotonConfig, RadiosityConfig,
    )
    from flatmatch.diff.render import (
        make_diff_renderer, make_diff_renderer_sharded,
    )
    from flatmatch.engines import radiosity
    from flatmatch.ops.device_scene import pack_emitters, pack_rects
    from flatmatch.parallel.mesh import photon_mesh
    from flatmatch.render import _auto_mesh, run_engine
    from flatmatch.scene.rect_dump import load_rect_dump

    n_dev = jax.device_count()
    check("devices", n_dev, "== 4", n_dev == 4)
    scene = load_rect_dump(FLAGSHIP)
    mesh = _auto_mesh()
    check("auto mesh size", mesh.shape["photons"], "== 4",
          mesh.shape["photons"] == 4)

    rc = cli.main([*SHARED_HOST_ARGS, "--out", str(tmp / "one_process")])
    check("one-process cli exit code", rc, "== 0", rc == 0)
    a, b = raw_tiles(tmp / "shared_host"), raw_tiles(tmp / "one_process")
    check("shared-host tiles", a.shape, f"== {b.shape}", a.shape == b.shape)
    rel = abs(float(a.sum()) / float(b.sum()) - 1.0)
    check("two processes vs one: energy rel err", f"{rel:.3e}", "< 0.02",
          rel < 0.02)
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    check("two processes vs one: texel correlation", f"{corr:.5f}", "> 0.98",
          corr > 0.98)

    pcfg = PhotonConfig(samples_per_area=1e7)
    cfg = DEFAULT_CONFIG.replace(photon=pcfg)
    out = {}
    for label, m in (("one card", None), ("four cards", mesh)):
        run_engine(scene, cfg, mesh=m)  # compile
        t0 = time.perf_counter()
        out[label] = run_engine(scene, cfg, mesh=m)
        log(f"  photon render ({label}): {time.perf_counter() - t0:.3f} s")
    compare_photon("sharded photon vs one card", out["four cards"],
                   out["one card"], scene)

    rcfg = RadiosityConfig(rays_per_texel=2000, iterations=7, seed=5)
    one = radiosity.render_radiosity(scene, rcfg)
    t0 = time.perf_counter()
    four = radiosity.render_radiosity_sharded(scene, rcfg, mesh)
    log(f"  sharded radiosity rays=2000: {time.perf_counter() - t0:.2f} s")
    compare_radiosity("sharded radiosity vs one card", four, one, scene,
                      0.02, lambda t: 0.08 if t >= 64 else 0.2, 0.99)

    mini = load_rect_dump(FIX / "mini_rects.txt")
    dcfg = PhotonConfig(samples_per_area=50000.0, photons_per_batch=8192)
    rects = pack_rects(mini.walls)
    ems = pack_emitters(mini, dcfg.samples_per_area, dcfg.window_color,
                        dcfg.light_color)
    a0 = jnp.full((rects.pos.shape[0],), dcfg.albedo, jnp.float32)
    p0 = jnp.ones((ems.pos.shape[0],), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(0), (mini.num_texels, 3)) ** 2
    grads = {}
    for label, r in (
        ("one card", make_diff_renderer(rects, ems, mini.num_texels, dcfg)),
        ("four cards", make_diff_renderer_sharded(
            rects, ems, mini.num_texels, dcfg, photon_mesh())),
    ):
        v, (ga, gp) = jax.value_and_grad(
            lambda a, p, r=r: jnp.sum(r(a, p) * w), argnums=(0, 1))(a0, p0)
        grads[label] = (float(v), np.asarray(ga), np.asarray(gp))
    (v1, ga1, gp1), (v4, ga4, gp4) = grads["one card"], grads["four cards"]
    rel = abs(v4 / v1 - 1.0)
    check("sharded value_and_grad: loss rel diff", f"{rel:.3e}", "< 0.02",
          rel < 0.02)
    cos = float(ga1 @ ga4 / (np.linalg.norm(ga1) * np.linalg.norm(ga4)))
    check("albedo gradient cosine", f"{cos:.5f}", "> 0.98", cos > 0.98)
    relp = float(np.abs(gp4 / gp1 - 1.0).max())
    check("power gradient max rel diff", f"{relp:.3e}", "< 0.02",
          relp < 0.02)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    if not (REPO / "flatmatch" / "__init__.py").exists():
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    with tempfile.TemporaryDirectory() as td:
        return run(args, pathlib.Path(td))


def run(args, tmp) -> int:
    import jax

    t_all = time.perf_counter()
    if args.four_cards:
        # before this process takes the cards
        log("[four cards] two processes sharing the host")
        launch_shared_host(tmp)
    jax.config.update("jax_platforms", "cuda")
    try:
        devices = jax.devices()
    except (RuntimeError, AssertionError) as e:  # no CUDA backend at all
        print(f"chip_smoke: no CUDA device: {e}", file=sys.stderr)
        return 3
    if devices[0].platform != "gpu":
        print(f"chip_smoke: platform {devices[0].platform!r}, not gpu",
              file=sys.stderr)
        return 3

    import jaxlib

    from flatmatch.backend import choose_engine
    from flatmatch.utils.cache import enable_compilation_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}, compile cache "
        f"{enable_compilation_cache()}")
    log(f"devices: {len(devices)} x {devices[0].device_kind}; default "
        f"photon engine: {choose_engine(None).value}")

    if args.four_cards:
        log("[four cards] sharded photon, radiosity and gradient")
        four_cards(tmp)
    else:
        scene = None
        for name, fn in (
            ("1 PNG entry", lambda: phase_png_entry(tmp)),
            ("2 flagship at the production budget",
             lambda: phase_flagship(tmp)),
            ("3 photon vs the reference engine",
             lambda: phase_photon_reference(scene)),
            ("4 ambient occlusion", lambda: phase_ao(scene)),
            ("5 radiosity", lambda: phase_radiosity(scene)),
            ("6 inverse rendering", lambda: phase_inverse(tmp)),
            ("7 kernel vs XLA", lambda: phase_kernel_vs_xla(scene)),
        ):
            log(f"[phase {name}]")
            t0 = time.perf_counter()
            out = fn()
            scene = out if out is not None else scene
            log(f"[phase {name}] done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
