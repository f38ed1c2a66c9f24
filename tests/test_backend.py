"""Where the renderer runs: engine choice per platform, the compile-cache
rules, one card per process, and the native library's build name."""
import os
import pathlib

import jax
import pytest

from flatmatch import backend
from flatmatch.config import Engine
from flatmatch.parallel import multihost
from flatmatch.utils import cache

E = Engine


@pytest.mark.parametrize(
    "requested,plat,expected",
    [
        (None, "gpu", E.PHOTON_PALLAS),
        (None, "cpu", E.PHOTON_XLA),
        (E.PHOTON_XLA, "gpu", E.PHOTON_XLA),
        (E.PHOTON_PALLAS, "gpu", E.PHOTON_PALLAS),
        (E.AMBIENT_OCCLUSION, "cpu", E.AMBIENT_OCCLUSION),
        (E.RADIOSITY, "gpu", E.RADIOSITY),
        (E.PHOTON_ORACLE, "cpu", E.PHOTON_ORACLE),
    ],
)
def test_choose_engine(requested, plat, expected):
    assert backend.choose_engine(requested, plat) is expected


@pytest.mark.parametrize("plat", ["cpu", "rocm"])
def test_kernel_engine_off_gpu_is_an_error(plat):
    with pytest.raises(ValueError, match="photon_pallas"):
        backend.choose_engine(E.PHOTON_PALLAS, plat)


def test_platform_without_default_is_an_error():
    with pytest.raises(ValueError, match="no default"):
        backend.choose_engine(None, "rocm")


@pytest.mark.parametrize(
    "interpret,plat,ok",
    [(False, "cpu", False), (True, "cpu", True), (False, "gpu", True)],
)
def test_require_kernel_backend(interpret, plat, ok):
    if ok:
        backend.require_kernel_backend(interpret, plat)
    else:
        with pytest.raises(ValueError, match="interpret"):
            backend.require_kernel_backend(interpret, plat)


def test_render_path_refuses_kernel_engine_on_cpu():
    """run_engine with the kernel engine named explicitly on the CPU
    raises instead of falling back to the XLA engine."""
    from flatmatch.config import DEFAULT_CONFIG
    from flatmatch.render import run_engine
    from flatmatch.scene.rect_dump import load_rect_dump
    from tests.conftest import FIXTURES

    scene = load_rect_dump(FIXTURES / "tiny_rects.txt")
    cfg = DEFAULT_CONFIG.replace(engine=E.PHOTON_PALLAS)
    with pytest.raises(ValueError, match="GPU kernel"):
        run_engine(scene, cfg, mesh=None)


def test_describe_names_the_devices():
    d = backend.describe()
    assert d.startswith("cpu: ") and d.endswith(f"x{jax.device_count()}")


@pytest.fixture
def cache_env(monkeypatch):
    """Restore JAX's cache settings after a test that changes them."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("FLATMATCH_NO_COMPILE_CACHE", raising=False)
    yield monkeypatch
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_uses_env_dir_and_sets_nothing(cache_env, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.enable_compilation_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_checkout_dir(cache_env):
    got = cache.enable_compilation_cache()
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert got == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert pathlib.Path(got).is_dir()


def test_cache_opt_out(cache_env):
    jax.config.update("jax_compilation_cache_dir", None)
    cache_env.setenv("FLATMATCH_NO_COMPILE_CACHE", "1")
    assert cache.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


@pytest.mark.parametrize(
    "coordinator,n,pid,cards,expected",
    [
        ("localhost:8476", 2, 1, 4, [2, 3]),
        ("localhost:8476", 4, 3, 4, [3]),
        ("127.0.0.1:9000", 2, 0, 2, [0]),
        ("[::1]:9000", 4, 1, 8, [2, 3]),
        ("10.0.0.2:8476", 2, 1, 4, None),  # processes on several hosts
        ("localhost:8476", 1, 0, 4, None),  # one process drives every card
        ("localhost:8476", 2, 1, None, None),  # no card on this host
        (None, None, None, 4, None),
    ],
)
def test_one_card_per_local_process(coordinator, n, pid, cards, expected):
    assert multihost.local_devices_for(coordinator, n, pid, cards) == expected


@pytest.mark.parametrize("n,cards", [(3, 4), (8, 4)])
def test_uneven_card_split_is_refused(n, cards):
    with pytest.raises(ValueError, match="cannot split"):
        multihost.local_devices_for("localhost:8476", n, 0, cards)


@pytest.mark.parametrize(
    "platforms,visible,expected",
    [("cpu", "0,1", None), ("cuda", "0,1,2,3", 4), ("", "2", 1),
     ("cuda", "", None)],
)
def test_host_card_count(monkeypatch, platforms, visible, expected):
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert multihost.host_card_count() == expected


@pytest.mark.parametrize("var", [None, "JAX_COORDINATOR_ADDRESS",
                                 "COORDINATOR_ADDRESS"])
def test_cluster_declared_only_by_coordinator_variables(monkeypatch, var):
    for k in multihost._CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    if var:
        monkeypatch.setenv(var, "localhost:8476")
    assert multihost.cluster_configured() == bool(var)


def test_native_library_named_by_source_hash():
    """The ctypes library is built from raster.cc into a file named after
    the source's hash: an edited source can never load a stale build."""
    import hashlib

    from flatmatch import native

    src = pathlib.Path(native.__file__).with_name("raster.cc")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    assert native.library_path().name == f"libflatmatch_raster-{digest}.so"
    if native.available():
        assert native.library_path().exists()
    assert os.path.dirname(native.library_path()) == str(src.parent)
