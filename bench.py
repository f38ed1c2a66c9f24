#!/usr/bin/env python
"""Benchmark: photon throughput on the flagship scene (BASELINE.md).

Prints ONE JSON line:
  {"metric": "photons_per_s", "value": N, "unit": "photons/s",
   "vs_baseline": R, "extras": {...}}

The scene is the reference's example.png layout, rebuilt from its rect dump
(tests/fixtures/example_rects.txt). vs_baseline compares against the
reference's own single-threaded C photon mapper measured on a CPU on the
same scene (BASELINE_MEASURED.json); when that file is absent, vs_baseline
is null. `extras` names the device, the engine, and the AO and radiosity
rates.

Runs on the GPU and fails without one; FLATMATCH_BENCH_CPU=1 runs it on the
CPU instead (the tests do, at a tiny budget).
"""
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

CPU = os.environ.get("FLATMATCH_BENCH_CPU") == "1"
jax.config.update("jax_platforms", "cpu" if CPU else "cuda")

from flatmatch.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402

from flatmatch.backend import choose_engine  # noqa: E402
from flatmatch.config import Engine, PhotonConfig  # noqa: E402
from flatmatch.engines import schedule  # noqa: E402
from flatmatch.ops.aa_scene import pack_aa  # noqa: E402
from flatmatch.ops.device_scene import pack_emitters, pack_rects  # noqa: E402
from flatmatch.scene.rect_dump import load_rect_dump  # noqa: E402

SCENE = REPO / "tests" / "fixtures" / "example_rects.txt"

TARGET_PHOTONS = int(os.environ.get("FLATMATCH_BENCH_PHOTONS", 1 << 28))
BATCH = int(os.environ.get("FLATMATCH_BENCH_BATCH", 1 << 17))
# in-kernel counter-hash RNG (cfg.device_rng), the CLI default
DEVICE_RNG = os.environ.get("FLATMATCH_BENCH_RNG", "1") == "1"
# the secondary engine benches (AO texel-rays/s, radiosity rays/s)
BENCH_ALL = os.environ.get("FLATMATCH_BENCH_ALL", "1") == "1"
RADIOSITY_RAYS = int(os.environ.get("FLATMATCH_BENCH_RADIOSITY_RAYS", 1000))
RUNS = 3


def _best_of(fn, runs=RUNS):
    """(min seconds over `runs` calls after one warm-up, energy)."""
    float(np.asarray(fn()).sum())
    dt, energy = float("inf"), None
    for _ in range(runs):
        t0 = time.perf_counter()
        energy = float(np.asarray(fn()).sum())
        dt = min(dt, time.perf_counter() - t0)
        assert np.isfinite(energy) and energy > 0
    return dt, energy


def bench_ao(scene):
    """AO texel-rays/s (photonmap.c:436-491: 481 geoSphere4 dirs/texel)."""
    from flatmatch.config import AoConfig
    from flatmatch.engines import ao
    from flatmatch.scene.rectangle import num_tiles

    rays = sum(num_tiles(r) for r in scene.walls) * 481
    rects = pack_rects(scene.walls)
    dt, _ = _best_of(lambda: ao.render_ao(scene, rects, AoConfig()))
    return rays / dt


def bench_radiosity(scene):
    """Radiosity form-factor rays/s at a reduced ray budget (production is
    rays_per_texel=10000, radiosityNative.c:147). Returns (rate, s/pass)."""
    from flatmatch.config import RadiosityConfig
    from flatmatch.engines import radiosity
    from flatmatch.scene.rectangle import num_tiles

    cfg = RadiosityConfig(rays_per_texel=RADIOSITY_RAYS, seed=0)
    rays = sum(num_tiles(r) for r in scene.walls) * RADIOSITY_RAYS
    dt, _ = _best_of(lambda: radiosity.render_radiosity(scene, cfg))
    return rays / dt, dt


def main():
    dev = jax.devices()[0]
    scene = load_rect_dump(SCENE)
    # samples_per_area so that the total budget ~= TARGET_PHOTONS
    probe = pack_emitters(scene, 1.0, (18, 18, 18), (16, 16, 18))
    spa = TARGET_PHOTONS / float(np.asarray(probe.area).sum())
    cfg = PhotonConfig(
        samples_per_area=spa, photons_per_batch=BATCH, seed=0,
        device_rng=DEVICE_RNG,
    )
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(scene, spa, cfg.window_color, cfg.light_color)
    n_photons = int(np.asarray(emitters.counts).sum())

    engine = choose_engine(None)
    kernel = aa = None
    if engine is Engine.PHOTON_PALLAS:
        from flatmatch.engines.photon_triton import KernelSpec

        aa = pack_aa(scene.walls)
        kernel = KernelSpec(aa.group_counts)

    def run():
        return schedule.render_photons(
            rects, emitters, scene.num_texels, cfg, kernel=kernel, aa=aa
        )

    dt, _ = _best_of(run)
    rate = n_photons / dt

    ref_meta = {}
    baseline_file = REPO / "BASELINE_MEASURED.json"
    if baseline_file.exists():
        ref_meta = json.loads(baseline_file.read_text())
    ref_rate = ref_meta.get("reference_photons_per_s")
    vs = rate / ref_rate if ref_rate else None

    extras = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
        "engine": engine.value,
        "device_rng": DEVICE_RNG,
        "photons": n_photons,
        "photon_s": dt,
    }
    if BENCH_ALL:
        extras["ao_texel_rays_per_s"] = bench_ao(scene)
        rad_rate, rad_dt = bench_radiosity(scene)
        extras["radiosity_rays_per_s"] = rad_rate
        extras["radiosity_s"] = rad_dt
        extras["radiosity_rays_per_texel"] = RADIOSITY_RAYS

    print(
        json.dumps(
            {
                "metric": "photons_per_s",
                "value": rate,
                "unit": "photons/s",
                "vs_baseline": vs,
                "extras": extras,
            }
        )
    )


if __name__ == "__main__":
    main()
