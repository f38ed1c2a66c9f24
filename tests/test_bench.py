"""Smoke-gate for bench.py — the driver's round-end artifact generator.

The driver runs `python bench.py` on real hardware and records its single
JSON line; if bench.py breaks, the round loses its benchmark record. This
runs it in-subprocess on CPU at a tiny budget (the XLA engine path; the
GPU kernel path runs on the card) and asserts
the output contract: exactly one parseable JSON line with the documented
keys and a positive rate.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.fast
def test_bench_prints_one_json_line():
    env = dict(os.environ)
    env.update(
        FLATMATCH_BENCH_CPU="1",
        FLATMATCH_BENCH_PHOTONS="16384",
        FLATMATCH_BENCH_BATCH="4096",
        FLATMATCH_BENCH_ALL="0",
    )
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py")],
        env=env,
        cwd=str(REPO),
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "photons_per_s"
    assert rec["unit"] == "photons/s"
    assert rec["value"] > 0
    assert "vs_baseline" in rec and "extras" in rec
