"""flatmatch: differentiable photon-mapping renderer in JAX for NVIDIA GPUs.

A JAX/XLA/Pallas framework with the capabilities of
rbuch703/flatmatch-global-illumination. See README.md for architecture and
PARITY.md for the reference component map.

Top-level API:

    from flatmatch import render, RenderConfig, Engine
    result = render("layout.png", out_dir="out", scale=30.0)
"""
from .config import DEFAULT_CONFIG, Engine, RenderConfig  # noqa: F401
from .render import RenderResult, compile_scene, render  # noqa: F401

__version__ = "0.1.0"
