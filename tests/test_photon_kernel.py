"""The photon trace kernel's wrapper, draws and deposits (interpret mode on
the CPU), the deposit splat, and one on-card check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.engines import photon, photon_triton as pt
from flatmatch.engines.schedule import emitter_slice
from flatmatch.ops.aa_scene import F_AA, pack_aa
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.ops.splat import scatter_splat
from flatmatch.scene.rect_dump import load_rect_dump
from tests.conftest import FIXTURES

CFG = PhotonConfig(photons_per_batch=512, seed=4)
U = photon.uniforms_per_photon(CFG.max_depth)

_scenes = {}


def scene_of(name):
    if name not in _scenes:
        scene = load_rect_dump(FIXTURES / f"{name}_rects.txt")
        ems = pack_emitters(scene, 1.0, CFG.window_color, CFG.light_color)
        _scenes[name] = (scene, pack_rects(scene.walls), pack_aa(scene.walls),
                         ems)
    return _scenes[name]


def spec(aa, block=64):
    return pt.KernelSpec(aa.group_counts, block=block, interpret=True)


def uniforms(key, B):
    return jax.random.uniform(jax.random.PRNGKey(key), (B, U), jnp.float32)


xla_deposits = jax.jit(photon.trace_deposits, static_argnames=("cfg",))


@pytest.mark.parametrize(
    "name,block,B,n_valid,emitter",
    [
        ("tiny", 32, 300, 300, 0),     # partial last block
        ("tiny", 64, 1024, 1000, 0),
        ("tiny", 128, 777, 700, 0),    # partial block and masked tail
        ("mini", 64, 1000, 1000, 0),
        ("mini", 256, 513, 513, 1),    # one photon in the last block
        ("example", 128, 640, 600, 3),
    ],
)
def test_kernel_deposits_equal_trace_batch(name, block, B, n_valid, emitter):
    """Same draws, same deposit stream as engines/photon.trace_deposits:
    every texel id and color, over scenes, block sizes and batches that
    are not a multiple of the block."""
    scene, rects, aa, ems = scene_of(name)
    em = emitter_slice(ems, emitter)
    u = uniforms(B + block, B)
    xi, xc = xla_deposits(rects, em, u, n_valid, CFG)
    ki, kc = pt.trace_deposits(aa.fields, aa.base, pt.emitter_vector(em), u,
                               n_valid, CFG, spec(aa, block))
    assert ki.shape == (CFG.max_depth, B) and ki.dtype == jnp.int32
    assert kc.shape == (3, CFG.max_depth, B) and kc.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(ki), np.asarray(xi))
    np.testing.assert_array_equal(np.asarray(kc), np.asarray(xc))
    assert (np.asarray(ki) != photon.DEAD).any()


def test_dead_photons_deposit_nothing():
    scene, rects, aa, ems = scene_of("tiny")
    ki, kc = pt.trace_deposits(
        aa.fields, aa.base, pt.emitter_vector(emitter_slice(ems, 0)),
        uniforms(1, 256), 100, CFG, spec(aa),
    )
    ki, kc = np.asarray(ki), np.asarray(kc)
    assert (ki[:, 100:] == photon.DEAD).all()
    assert (kc[:, :, 100:] == 0).all()
    dead = ki == photon.DEAD
    assert (kc[:, dead] == 0).all()
    assert (ki[~dead] < scene.num_texels).all() and (ki[~dead] >= 0).all()


@pytest.mark.parametrize(
    "bad",
    ["uniform_columns", "block", "fields"],
)
def test_wrapper_rejects_bad_shapes(bad):
    scene, rects, aa, ems = scene_of("tiny")
    ev = pt.emitter_vector(emitter_slice(ems, 0))
    u, fields, s = uniforms(2, 128), aa.fields, spec(aa)
    if bad == "uniform_columns":
        u = u[:, :-1]
    elif bad == "block":
        s = pt.KernelSpec(aa.group_counts, block=96, interpret=True)
    else:
        fields = fields[: F_AA - 1]
    with pytest.raises(ValueError):
        pt.trace_deposits(fields, aa.base, ev, u, 128, CFG, s)


def test_kernel_off_gpu_needs_interpret():
    """Asking for the compiled kernel where there is no GPU is an error,
    not a silent interpreter or XLA run."""
    scene, rects, aa, ems = scene_of("tiny")
    lm0 = jnp.zeros((scene.num_texels, 3), jnp.float32)
    with pytest.raises(ValueError, match="GPU"):
        pt.trace_batch_kernel(lm0, aa, emitter_slice(ems, 0),
                              uniforms(3, 128), 128, CFG,
                              pt.KernelSpec(aa.group_counts))


@pytest.mark.parametrize("drop_dead", [False, True])
def test_scatter_sums_duplicate_deposits(drop_dead):
    """Many deposits on one texel all land (the GPU bins them with atomic
    adds; the CPU in stream order); DEAD ids are dropped, never wrapped
    onto a real texel."""
    T, D, B = 5, 3, 40
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2, (D, B)).astype(np.int32)  # texels 0 and 1 only
    col = rng.uniform(0, 1, (3, D, B)).astype(np.float32)
    if drop_dead:
        idx[:, ::3] = photon.DEAD
    out = np.asarray(scatter_splat(jnp.zeros((T, 3), jnp.float32),
                                   jnp.asarray(idx), jnp.asarray(col)))
    want = np.zeros((T, 3), np.float64)
    for d in range(D):
        for b in range(B):
            if idx[d, b] != photon.DEAD:
                want[idx[d, b]] += col[:, d, b]
    np.testing.assert_allclose(out, want, rtol=1e-5)
    assert (out[2:] == 0).all()


def test_emitter_vector_layout():
    scene, rects, aa, ems = scene_of("mini")
    em = emitter_slice(ems, 0)
    v = np.asarray(pt.emitter_vector(em))
    assert v.shape == (16,)
    np.testing.assert_array_equal(v[0:3], np.asarray(em.pos))
    np.testing.assert_array_equal(v[9:12], np.asarray(em.n))
    np.testing.assert_array_equal(v[12:15], np.asarray(em.color))
    assert v[15] == (1.0 if bool(em.is_window) else 0.0)


def test_device_rng_deterministic_per_seed():
    scene, rects, aa, ems = scene_of("tiny")
    ev = pt.emitter_vector(emitter_slice(ems, 0))

    def run(seed):
        return tuple(np.asarray(x) for x in pt.trace_deposits_rng(
            aa.fields, aa.base, ev, seed, 256, 256, CFG, spec(aa)))

    a, a2, b = run(5), run(5), run(6)
    np.testing.assert_array_equal(a[0], a2[0])
    np.testing.assert_array_equal(a[1], a2[1])
    assert (a[0] != b[0]).any()


def test_hash_draws_are_uniform():
    """The counter hash's 24-bit uniforms: in [0, 1), mean 1/2, variance
    1/12, and no correlation between neighbouring draw columns."""
    gid = jnp.arange(1 << 16, dtype=jnp.int32)
    seed = pt.batch_seed(0, 3)
    x = np.asarray(pt._hash_draw(seed, gid, jnp.int32(0)), np.float64)
    y = np.asarray(pt._hash_draw(seed, gid, jnp.int32(1)), np.float64)
    assert x.min() >= 0.0 and x.max() < 1.0
    assert abs(x.mean() - 0.5) < 0.01
    assert abs(x.var() - 1 / 12) < 0.003
    assert abs(np.corrcoef(x, y)[0, 1]) < 0.02


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla(gpu):
    """On the card: compiled kernel vs the XLA engine on shared draws
    (statistical: Triton's transcendentals differ in the last bits)."""
    scene, rects, aa, ems = scene_of("example")
    em = emitter_slice(ems, 0)
    u = uniforms(9, 1 << 14)
    xi, xc = xla_deposits(rects, em, u, 1 << 14, CFG)
    ki, kc = pt.trace_deposits(aa.fields, aa.base, pt.emitter_vector(em), u,
                               1 << 14, CFG, pt.KernelSpec(aa.group_counts))
    xi, ki = np.asarray(xi), np.asarray(ki)
    live = (xi != photon.DEAD) & (ki != photon.DEAD)
    assert (xi == ki)[live].mean() > 0.99
    np.testing.assert_allclose(float(np.asarray(kc).sum()),
                               float(np.asarray(xc).sum()), rtol=1e-3)
