"""Differentiable rendering: replay-VJP gradients vs plain autodiff and
finite differences (SURVEY.md §4: finite-difference gradient checks;
BASELINE.md differentiability gate)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.diff.render import make_autodiff_oracle, make_diff_renderer
from flatmatch.engines import schedule
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.scene import geometry, image as im, layout
from tests.conftest import FIXTURES

f32 = np.float32

CFG = PhotonConfig(samples_per_area=2000.0, photons_per_batch=512, seed=5)


@pytest.fixture(scope="module")
def setup():
    img = im.load_layout(str(FIXTURES / "tiny.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    n_rects = rects.pos.shape[0]
    n_em = emitters.pos.shape[0]
    albedo0 = jnp.full((n_rects,), CFG.albedo, jnp.float32)
    power0 = jnp.ones((n_em,), jnp.float32)
    # fixed random projection -> scalar loss
    w = jax.random.normal(jax.random.PRNGKey(0), (scene.num_texels, 3)) ** 2
    render = make_diff_renderer(rects, emitters, scene.num_texels, CFG)
    oracle = make_autodiff_oracle(rects, emitters, scene.num_texels, CFG)
    return scene, rects, emitters, albedo0, power0, w, render, oracle


def test_forward_matches_plain_engine(setup):
    """At uniform albedo=0.9 and power=1 the differentiable renderer must
    reproduce the plain engine bit-for-bit (same RNG schedule)."""
    scene, rects, emitters, albedo0, power0, w, render, oracle = setup
    lm_diff = np.asarray(render(albedo0, power0))
    lm_plain = np.asarray(
        schedule.render_photons(rects, emitters, scene.num_texels, CFG)
    )
    np.testing.assert_array_equal(lm_diff, lm_plain)


def test_replay_vjp_matches_autodiff(setup):
    scene, rects, emitters, albedo0, power0, w, render, oracle = setup

    def loss_replay(a, p):
        return jnp.sum(render(a, p) * w)

    def loss_oracle(a, p):
        return jnp.sum(oracle(a, p) * w)

    ga, gp = jax.grad(loss_replay, argnums=(0, 1))(albedo0, power0)
    oa, op = jax.grad(loss_oracle, argnums=(0, 1))(albedo0, power0)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(oa), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(gp), np.asarray(op), rtol=1e-4)
    # something actually flows
    assert np.abs(np.asarray(ga)).sum() > 0
    assert np.abs(np.asarray(gp)).sum() > 0


def test_gradients_match_finite_differences(setup):
    scene, rects, emitters, albedo0, power0, w, render, oracle = setup

    def loss(a, p):
        return float(jnp.sum(render(a, p) * w))

    ga, gp = jax.grad(
        lambda a, p: jnp.sum(render(a, p) * w), argnums=(0, 1)
    )(albedo0, power0)
    ga, gp = np.asarray(ga), np.asarray(gp)

    # central differences on the 3 largest-gradient albedo entries + power[0]
    h = 1e-2
    for i in np.argsort(-np.abs(ga))[:3]:
        ap = albedo0.at[i].add(h)
        am = albedo0.at[i].add(-h)
        fd = (loss(ap, power0) - loss(am, power0)) / (2 * h)
        np.testing.assert_allclose(ga[i], fd, rtol=5e-2)

    pp = power0.at[0].add(h)
    pm = power0.at[0].add(-h)
    fd = (loss(albedo0, pp) - loss(albedo0, pm)) / (2 * h)
    np.testing.assert_allclose(gp[0], fd, rtol=5e-2)


def test_power_gradient_is_exact_linearity(setup):
    """The lightmap is linear in each emitter's power, so
    dL/dpower[e] * power[e] must equal that emitter's total weighted
    contribution; with one emitter, loss == gp * power."""
    scene, rects, emitters, albedo0, power0, w, render, oracle = setup
    if emitters.pos.shape[0] != 1:
        pytest.skip("needs single-emitter scene")

    def loss(p):
        return jnp.sum(render(albedo0, p) * w)

    val = float(loss(power0))
    gp = float(jax.grad(loss)(power0)[0])
    np.testing.assert_allclose(gp, val, rtol=1e-5)


def test_sharded_diff_renderer(setup):
    """Multi-chip diff renderer: deterministic, gradients flow, psum-reduced
    cotangents finite; compare against the single-device replay gradient
    DIRECTIONALLY (different RNG partition -> statistical agreement)."""
    import jax.numpy as jnp

    from flatmatch.diff.render import make_diff_renderer_sharded
    from flatmatch.parallel.mesh import photon_mesh

    scene, rects, emitters, albedo0, power0, w, render, oracle = setup
    mesh = photon_mesh()
    sharded = make_diff_renderer_sharded(
        rects, emitters, scene.num_texels, CFG, mesh
    )

    def loss_sh(a, p):
        return jnp.sum(sharded(a, p) * w)

    val1 = float(loss_sh(albedo0, power0))
    val2 = float(loss_sh(albedo0, power0))
    assert val1 == val2  # deterministic
    ga, gp = jax.grad(loss_sh, argnums=(0, 1))(albedo0, power0)
    ga, gp = np.asarray(ga), np.asarray(gp)
    assert np.isfinite(ga).all() and np.isfinite(gp).all()
    assert np.abs(ga).sum() > 0 and np.abs(gp).sum() > 0

    # statistical agreement with the single-device estimate
    ga1, gp1 = jax.grad(
        lambda a, p: jnp.sum(render(a, p) * w), argnums=(0, 1)
    )(albedo0, power0)
    np.testing.assert_allclose(gp, np.asarray(gp1), rtol=0.1)
    # cosine similarity of albedo gradients (MC noise on small entries)
    a1 = np.asarray(ga1).ravel()
    a2 = ga.ravel()
    cos = a1 @ a2 / (np.linalg.norm(a1) * np.linalg.norm(a2) + 1e-30)
    assert cos > 0.98, cos


def test_fit_power_recovers_exactly(setup):
    """Inverse rendering, power-only: the target is rendered at known
    emitter powers with the same seed, so the true powers are an exact
    global optimum; the fit must recover them to ~1%."""
    from flatmatch.diff.fit import fit_materials

    scene, rects, emitters, albedo0, power0, w, render, oracle = setup
    n_em = len(np.asarray(emitters.counts))
    power_true = jnp.asarray(
        1.0 + 0.4 * (np.arange(n_em) + 1) / n_em, jnp.float32
    )
    target = render(albedo0, power_true)

    res = fit_materials(
        target, rects, emitters, scene.num_texels, CFG,
        steps=150, learning_rate=0.05, fit_albedo=False,
    )
    assert res.losses[-1] < 1e-4, res.losses[-1]
    np.testing.assert_allclose(res.power, np.asarray(power_true), rtol=0.01)
    # albedo was held at its init
    np.testing.assert_allclose(res.albedo, CFG.albedo, atol=1e-6)


def test_fit_materials_joint(setup):
    """Joint albedo+power fit: loss collapses and the fitted parameters
    reproduce the target lightmap."""
    from flatmatch.diff.fit import fit_materials

    scene, rects, emitters, albedo0, power0, w, render, oracle = setup
    n_rects = len(np.asarray(albedo0))
    rng = np.random.RandomState(3)
    albedo_true = jnp.asarray(
        0.6 + 0.3 * rng.rand(n_rects), jnp.float32
    )
    power_true = jnp.asarray([1.3] * len(np.asarray(power0)), jnp.float32)
    target = np.asarray(render(albedo_true, power_true))

    res = fit_materials(
        target, rects, emitters, scene.num_texels, CFG,
        steps=120, learning_rate=0.1,
    )
    assert res.losses[-1] < res.losses[0] / 50, (
        res.losses[0], res.losses[-1]
    )
    # fitted render explains the target
    rel = float(
        np.mean((res.lightmap - target) ** 2) / np.mean(target**2)
    )
    assert rel < 2e-3, rel


def test_fit_layout_rejects_mismatched_target(tmp_path):
    """fit_layout must refuse raw tiles whose dimensions don't match the
    compiled scene (wrong layout or scale) instead of mis-assembling."""
    import pytest

    from flatmatch.config import DEFAULT_CONFIG, Engine
    from flatmatch.diff.fit import fit_layout
    from flatmatch.render import render
    from tests.conftest import FIXTURES

    cfg = DEFAULT_CONFIG.replace(
        engine=Engine.PHOTON_XLA,
        photon=CFG,
    )
    render(str(FIXTURES / "tiny.png"), str(tmp_path), 30.0, cfg,
           dump_raw=True)
    with pytest.raises(ValueError, match="wall 0"):
        # scale 15 halves the texel grid -> dimension mismatch
        fit_layout(str(FIXTURES / "tiny.png"), str(tmp_path / "tiles"),
                   15.0, cfg, steps=1)
