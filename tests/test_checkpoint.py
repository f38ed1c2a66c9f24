"""Checkpoint/resume: interrupted renders are bit-identical to straight runs."""
import numpy as np
import pytest

from flatmatch.config import PhotonConfig
from flatmatch.engines import schedule
from flatmatch.ops.device_scene import pack_emitters, pack_rects
from flatmatch.scene import geometry, image as im, layout
from flatmatch.utils import checkpoint as ckpt
from flatmatch.utils.progress import Tracer
from tests.conftest import FIXTURES

f32 = np.float32

CFG = PhotonConfig(samples_per_area=30000.0, photons_per_batch=512, seed=2)


@pytest.fixture(scope="module")
def mini():
    img = im.load_layout(str(FIXTURES / "mini.png"))
    lay = layout.parse_layout(img, f32(1.0) / f32(30.0), 200.0)
    scene = geometry.Scene(lay)
    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene, CFG.samples_per_area, CFG.window_color, CFG.light_color
    )
    return scene, rects, emitters


def test_checkpointed_matches_straight(mini, tmp_path):
    scene, rects, emitters = mini
    straight = np.asarray(
        schedule.render_photons(rects, emitters, scene.num_texels, CFG)
    )
    path = str(tmp_path / "ck.npz")
    chunked = np.asarray(
        schedule.render_photons(
            rects, emitters, scene.num_texels, CFG, checkpoint_path=path,
            every_batches=2,
        )
    )
    np.testing.assert_array_equal(straight, chunked)


def test_resume_mid_run_is_bit_identical(mini, tmp_path):
    scene, rects, emitters = mini
    path = str(tmp_path / "ck.npz")
    counts = np.asarray(emitters.counts)
    # the engine fingerprints with (engine-name, batch-size) extras
    # (engines/schedule.py) so checkpoints can't cross engines/batchings
    fp = ckpt.config_fingerprint(
        CFG, scene.num_texels, counts,
        extra=("xla", CFG.photons_per_batch, 2),
    )

    # full checkpointed run (reference result), saving every segment
    full = np.asarray(
        schedule.render_photons(
            rects, emitters, scene.num_texels, CFG, checkpoint_path=path,
            every_batches=2,
        )
    )
    # rewind the checkpoint to a mid-run state and resume
    state = ckpt.load(path, fp)
    assert state is not None

    path2 = str(tmp_path / "ck2.npz")
    # simulate an interrupt: run with a huge budget of segments but stop by
    # writing only the first segment's checkpoint, then resume from it
    lightmap0 = np.zeros((scene.num_texels, 3), np.float32)
    import jax.numpy as jnp

    from flatmatch.engines.photon import EmitterSlice
    from flatmatch.engines.schedule import _trace_emitter

    B = CFG.photons_per_batch
    n = int(counts[0])
    n_batches = (n + B - 1) // B
    last_valid = n - (n_batches - 1) * B
    em = EmitterSlice(
        pos=emitters.pos[0], wvec=emitters.wvec[0], hvec=emitters.hvec[0],
        n=emitters.n[0], color=emitters.color[0],
        is_window=emitters.is_window[0],
    )
    import jax

    seg = min(2, n_batches)
    part = _trace_emitter(
        jnp.asarray(lightmap0), rects, em, jax.random.PRNGKey(CFG.seed),
        jnp.int32(0), jnp.int32(0), jnp.int32(seg), jnp.int32(n_batches),
        jnp.int32(last_valid), CFG, B,
    )
    ckpt.save(path2, np.asarray(part), 0, seg, fp)
    resumed = np.asarray(
        schedule.render_photons(
            rects, emitters, scene.num_texels, CFG, checkpoint_path=path2,
            every_batches=2,
        )
    )
    np.testing.assert_array_equal(full, resumed)


def test_wide_engine_kill_resume_bit_identical(mini, tmp_path, monkeypatch):
    """The trace-kernel engine checkpoints too (with the in-kernel RNG, the
    CLI default). Simulate a kill mid-render (after the first checkpoint
    write) and resume; the result must be bit-identical to an
    uninterrupted run (interpret mode)."""
    import dataclasses

    from flatmatch.engines.photon_triton import KernelSpec
    from flatmatch.ops.aa_scene import pack_aa

    scene, rects, emitters = mini
    aa = pack_aa(scene.walls)
    kernel = KernelSpec(aa.group_counts, interpret=True)
    cfg = dataclasses.replace(CFG, samples_per_area=4000.0, device_rng=True)
    emitters_small = pack_emitters(
        scene, cfg.samples_per_area, cfg.window_color, cfg.light_color
    )

    def run(**kw):
        return schedule.render_photons(
            rects, emitters_small, scene.num_texels, cfg, every_batches=1,
            kernel=kernel, aa=aa, **kw,
        )

    straight = np.asarray(run())
    path = str(tmp_path / "wide.npz")
    calls = {"n": 0}
    orig_save = ckpt.save

    def save_then_die(*a, **k):
        orig_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt("simulated kill")

    monkeypatch.setattr(ckpt, "save", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        run(checkpoint_path=path)
    monkeypatch.setattr(ckpt, "save", orig_save)

    resumed = np.asarray(run(checkpoint_path=path))
    np.testing.assert_array_equal(straight, resumed)
    assert straight.sum() > 0


def test_fingerprint_schema_version_restarts(mini, tmp_path):
    """A checkpoint from a different fingerprint SCHEMA version restarts
    gracefully (None) instead of raising a misleading config-mismatch
    error."""
    scene, rects, emitters = mini
    path = str(tmp_path / "old.npz")
    counts = np.asarray(emitters.counts)
    fp = ckpt.config_fingerprint(CFG, scene.num_texels, counts)
    ckpt.save(path, np.zeros((scene.num_texels, 3), np.float32), 0, 1, fp)
    # rewrite with a stale schema version marker
    with np.load(path) as z:
        data = dict(z)
    data["fp_version"] = np.int64(ckpt.FINGERPRINT_VERSION - 1)
    np.savez_compressed(path, **data)
    assert ckpt.load(path, fp) is None


def test_fingerprint_mismatch_refuses(mini, tmp_path):
    scene, rects, emitters = mini
    path = str(tmp_path / "ck.npz")
    counts = np.asarray(emitters.counts)
    fp = ckpt.config_fingerprint(CFG, scene.num_texels, counts)
    ckpt.save(path, np.zeros((scene.num_texels, 3), np.float32), 0, 1, fp)
    import dataclasses

    other = dataclasses.replace(CFG, seed=CFG.seed + 1)
    fp2 = ckpt.config_fingerprint(other, scene.num_texels, counts)
    with pytest.raises(ValueError):
        ckpt.load(path, fp2)


def test_tracer_phases():
    tr = Tracer(sink_path=None)
    with tr.phase("compile", scene="mini"):
        pass
    with tr.phase("trace"):
        pass
    assert [e["phase"] for e in tr.events] == ["compile", "trace"]
    assert "compile=" in tr.summary()
