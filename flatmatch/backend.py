"""Where the renderer runs, and which photon engine it runs there.

The one place that looks at the JAX backend. The GPU's default photon engine
is whichever of the trace kernel (engines/photon_triton.py) and the plain XLA
engine (engines/photon.py) rendered the flagship scene faster on the card
(PERF.md, "H100 bring-up findings"); the CPU's is the XLA engine. A kernel
engine asked for by name where it cannot compile is an error, never a
silent fallback.
"""
from __future__ import annotations

from typing import Optional

import jax

from .config import Engine

# default photon engine per platform (GPU: measured, PERF.md)
DEFAULT_PHOTON_ENGINE = {
    "gpu": Engine.PHOTON_PALLAS,
    "cpu": Engine.PHOTON_XLA,
}


def platform() -> str:
    return jax.default_backend()


def choose_engine(requested: Optional[Engine], plat: Optional[str] = None
                  ) -> Engine:
    """The engine a render runs: `requested`, or the platform's default
    photon engine when None. Raises ValueError for a kernel engine off the
    GPU or for a platform with no default."""
    plat = plat or platform()
    if requested is None:
        if plat not in DEFAULT_PHOTON_ENGINE:
            raise ValueError(f"no default photon engine for platform {plat!r}")
        return DEFAULT_PHOTON_ENGINE[plat]
    if requested is Engine.PHOTON_PALLAS and plat != "gpu":
        raise ValueError(
            f"engine {requested.value} runs a GPU kernel; platform is "
            f"{plat!r} (use --engine photon_xla)"
        )
    return requested


def require_kernel_backend(interpret: bool, plat: Optional[str] = None):
    """A Pallas GPU kernel compiles only for the GPU; elsewhere it runs only
    when the caller asks for the interpreter explicitly."""
    plat = plat or platform()
    if not interpret and plat != "gpu":
        raise ValueError(
            f"the photon trace kernel compiles for the GPU only (platform "
            f"{plat!r}); pass interpret=True to run it in the Pallas "
            f"interpreter"
        )


def describe() -> str:
    """'gpu: NVIDIA H100 80GB HBM3 x1' — the devices a render runs on."""
    devs = jax.devices()
    return f"{devs[0].platform}: {devs[0].device_kind} x{len(devs)}"
