"""Multi-chip photon sharding on the 8-device virtual CPU mesh (SURVEY.md §4:
multi-host tests on CPU fakes)."""
import dataclasses

import jax
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.engines import schedule
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.parallel.mesh import photon_mesh, render_photons_sharded
from flatmatch.scene import geometry, image as im, layout
from tests.conftest import FIXTURES

f32 = np.float32

CFG = PhotonConfig(samples_per_area=20000.0, photons_per_batch=1024, seed=11)


@pytest.fixture(scope="module")
def tiny():
    img = im.load_layout(str(FIXTURES / "tiny.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    return scene, rects, emitters


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_deterministic(tiny):
    scene, rects, emitters = tiny
    mesh = photon_mesh()
    a = np.asarray(
        render_photons_sharded(rects, emitters, scene.num_texels, CFG, mesh)
    )
    b = np.asarray(
        render_photons_sharded(rects, emitters, scene.num_texels, CFG, mesh)
    )
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0


def test_sharded_matches_single_chip_statistically(tiny):
    """Same photon budget, different RNG partition: the two estimates target
    the same integral, so aggregate energy must agree to MC tolerance."""
    scene, rects, emitters = tiny
    mesh = photon_mesh()
    sharded = np.asarray(
        render_photons_sharded(rects, emitters, scene.num_texels, CFG, mesh)
    )
    single = np.asarray(
        schedule.render_photons(rects, emitters, scene.num_texels, CFG)
    )
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded.sum(), single.sum(), rtol=0.02)
    # per-wall energy also agrees (coarser than per-texel, robust to noise)
    for r in scene.walls:
        from flatmatch.scene.rectangle import num_tiles

        s = sharded[r.base : r.base + num_tiles(r)].sum()
        t = single[r.base : r.base + num_tiles(r)].sum()
        if t > 1e3:  # skip nearly-unlit walls, pure noise
            np.testing.assert_allclose(s, t, rtol=0.15)


def test_sharded_wide_matches_sharded_xla(tiny):
    """The sharded trace-kernel engine keys draws per (batch, device)
    exactly like the sharded XLA engine, so the two trace identical photons
    and, with the CPU's in-order scatter, produce identical lightmaps
    (interpret mode)."""
    from flatmatch.engines.photon_triton import KernelSpec
    from flatmatch.ops.aa_scene import pack_aa

    scene, rects, emitters = tiny
    aa = pack_aa(scene.walls)
    mesh = photon_mesh()
    # reduced budget: the keying property is per-photon, not statistical
    cfg = dataclasses.replace(CFG, samples_per_area=4000.0)
    ems = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    xla = np.asarray(
        render_photons_sharded(rects, ems, scene.num_texels, cfg, mesh)
    )
    kernel = np.asarray(
        render_photons_sharded(
            rects, ems, scene.num_texels, cfg, mesh,
            kernel=KernelSpec(aa.group_counts, interpret=True), aa=aa,
        )
    )
    assert kernel.sum() > 0
    np.testing.assert_array_equal(kernel, xla)


def test_sharded_checkpoint_resume_bit_identical(tiny, tmp_path):
    """Sharded renders checkpoint/resume with the same bit-identity
    guarantee as single-device ones (fingerprint includes the mesh size)."""
    scene, rects, emitters = tiny
    mesh = photon_mesh()
    # bit-identity requires identical segmentation (the sharded engines
    # psum once per segment): pass the same every_batches to both
    straight = np.asarray(
        render_photons_sharded(
            rects, emitters, scene.num_texels, CFG, mesh, every_batches=2
        )
    )
    path = str(tmp_path / "ck.npz")
    chunked = np.asarray(
        render_photons_sharded(
            rects, emitters, scene.num_texels, CFG, mesh,
            checkpoint_path=path, every_batches=2,
        )
    )
    np.testing.assert_array_equal(straight, chunked)

    # the saved cursor resumes to the same result
    from flatmatch.utils import checkpoint as ckpt

    B = CFG.photons_per_batch
    fp = ckpt.config_fingerprint(
        CFG, scene.num_texels, np.asarray(emitters.counts),
        extra=("xla-sharded", 8, B, 2),
    )
    assert ckpt.load(path, fp) is not None


def test_pipeline_auto_selects_sharded_engine(tiny):
    """render.run_engine with mesh='auto' on the 8-device env dispatches the
    sharded engine and matches the single-device path statistically
    (VERDICT r1 #1: the dispatch IS the pipeline)."""
    from flatmatch.config import DEFAULT_CONFIG, Engine
    from flatmatch.render import run_engine

    scene, rects, emitters = tiny
    cfg = DEFAULT_CONFIG.replace(engine=Engine.PHOTON_XLA, photon=CFG)
    sharded = run_engine(scene, cfg, mesh="auto")
    single = run_engine(scene, cfg, mesh=None)
    np.testing.assert_allclose(
        sharded.sum(), single.sum(), rtol=0.02
    )


def test_sharded_radiosity_matches_statistically(tiny):
    """Radiosity with the ray axis sharded over the mesh targets the same
    integral as the single-device engine (different ray partition, so
    agreement is statistical)."""
    from flatmatch.config import RadiosityConfig
    from flatmatch.engines.radiosity import (
        render_radiosity, render_radiosity_sharded,
    )

    scene, rects, emitters = tiny
    cfg = RadiosityConfig(rays_per_texel=256, iterations=3, seed=4)
    single = render_radiosity(scene, cfg)
    sharded = render_radiosity_sharded(scene, cfg, photon_mesh())
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded.sum(), single.sum(), rtol=0.03)
    corr = np.corrcoef(sharded.ravel(), single.ravel())[0, 1]
    # per-texel MC sigma at 256 rays is ~6%; 0.98 is the matching bar
    assert corr > 0.98, corr
    # deterministic for fixed (seed, mesh)
    again = render_radiosity_sharded(scene, cfg, photon_mesh())
    np.testing.assert_array_equal(sharded, again)


def test_sharded_respects_last_batch_mask(tiny):
    """A photon budget that is not a multiple of (batch x devices) must not
    trace padding photons: energy scales linearly with the budget."""
    scene, rects, emitters = tiny
    mesh = photon_mesh()
    half_cfg = dataclasses.replace(CFG, samples_per_area=CFG.samples_per_area / 2)
    half_emitters = pack_emitters(
        scene, half_cfg.samples_per_area, CFG.window_color, CFG.light_color
    )
    full = np.asarray(
        render_photons_sharded(rects, emitters, scene.num_texels, CFG, mesh)
    )
    half = np.asarray(
        render_photons_sharded(
            rects, half_emitters, scene.num_texels, half_cfg, mesh
        )
    )
    np.testing.assert_allclose(half.sum() * 2, full.sum(), rtol=0.05)


def test_sharded_fit_recovers_power():
    """Inverse rendering over the photon mesh: a power-only fit against a
    target rendered by the SAME sharded renderer recovers the true powers
    (the mesh path of diff/fit.py)."""
    import jax.numpy as jnp

    from flatmatch.config import PhotonConfig
    from flatmatch.diff.fit import fit_materials, make_renderer
    from flatmatch.ops.device_scene import pack_emitters, pack_rects
    from flatmatch.parallel.mesh import photon_mesh
    from flatmatch.scene import geometry, image as im, layout
    from tests.conftest import FIXTURES

    img = im.load_layout(str(FIXTURES / "tiny.png"))
    lay = layout.parse_layout(
        img, np.float32(1.0) / np.float32(30.0), 200.0
    )
    scene = geometry.Scene(lay)
    cfg = PhotonConfig(samples_per_area=2000.0, photons_per_batch=512,
                       seed=9)
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )
    mesh = photon_mesh()
    render = make_renderer(rects, emitters, scene.num_texels, cfg,
                           mesh=mesh)
    n_em = len(np.asarray(emitters.counts))
    p_true = jnp.asarray(1.0 + 0.5 * (np.arange(n_em) + 1) / n_em,
                         jnp.float32)
    a0 = jnp.full((rects.pos.shape[0],), cfg.albedo, jnp.float32)
    target = np.asarray(render(a0, p_true))

    res = fit_materials(
        target, rects, emitters, scene.num_texels, cfg,
        mesh=mesh, steps=120, learning_rate=0.05, fit_albedo=False,
    )
    assert res.losses[-1] < 1e-4, res.losses[-1]
    np.testing.assert_allclose(res.power, np.asarray(p_true), rtol=0.02)


def test_sharded_segment_lowers_one_psum_and_local_batches(tiny):
    """Scaling regression guard (round-4 VERDICT #6): a sharded emitter
    segment must lower to exactly ONE all-reduce (the per-segment lightmap
    psum, mesh.py:100-103) and must draw uniforms at the SHARD-LOCAL batch
    size — a regression that psums per batch, or traces the global batch
    per device, would silently destroy scaling without failing any value
    test (virtual CPU devices share host cores, so timing tests can't see
    it either)."""
    import jax.numpy as jnp

    from flatmatch.engines.photon import uniforms_per_photon
    from flatmatch.engines.schedule import emitter_slice
    from flatmatch.parallel.mesh import _trace_emitter_sharded

    scene, rects, emitters = tiny
    cfg = CFG
    mesh = photon_mesh()
    n_dev = mesh.shape["photons"]
    B = 1024
    b_local = B // n_dev
    U = uniforms_per_photon(cfg.max_depth)
    lm = jnp.zeros((scene.num_texels, 3), jnp.float32)
    txt = _trace_emitter_sharded.lower(
        lm, rects, emitter_slice(emitters, 0), jax.random.PRNGKey(1),
        0, 0, 4, jnp.int32(4), jnp.int32(B), cfg, B, mesh,
    ).as_text()
    assert txt.count("all_reduce") == 1, txt.count("all_reduce")
    assert f"tensor<{b_local}x{U}xf32>" in txt, "shard-local uniforms"
    assert f"tensor<{B}x{U}xf32>" not in txt, "global-size uniforms leaked"
