"""chip_smoke.py refuses to run where it cannot prove anything: with no GPU,
and without the repository beside it. Either way it prints no result."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=str(cwd), env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses(tmp_path, where):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = _run(script, cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "[phase" not in out.stdout
