"""Multi-process launch support.

The reference is strictly single-process/single-device (SURVEY.md §2
"Collective backend: none"). Here the program scales out with the JAX
distributed runtime: every process runs the same program, `initialize()`
wires the JAX coordination service, and the photon mesh then spans all
global devices — no custom transport; the only collectives are the
per-segment lightmap/gradient psums (parallel/mesh.py, diff/render.py),
which XLA hands to NCCL on GPUs.

One process can drive every card of a host (the usual launch). Several
processes on one host split its cards evenly: with a coordinator on this
host (`localhost:<port>`) and P processes on C cards, process i takes cards
[i*C/P, (i+1)*C/P), because a JAX process reserves most of the memory of
every card it sees and a second process on the same card would run out of
it. JAX_LOCAL_DEVICE_IDS, when set, chooses the cards instead. Launch (same
command in every process):

    python -m flatmatch.cli render layout.png 30 \
        --coordinator localhost:8476 --num-processes 2 --process-id 0

or set JAX_COORDINATOR_ADDRESS (with JAX's own process variables) and call
`multihost.initialize()`.
"""
from __future__ import annotations

import os
import subprocess
from typing import Optional

import jax

from ..utils.progress import info


_initialized = False

# Env vars whose presence means "this process is part of a configured
# multi-process cluster" — jax.distributed auto-detection will use them.
_CLUSTER_ENV = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")

_LOCAL_HOSTS = ("localhost", "127.0.0.1", "[::1]")


def cluster_configured() -> bool:
    """True when the environment declares a multi-process cluster."""
    return any(os.environ.get(k) for k in _CLUSTER_ENV)


def host_card_count() -> Optional[int]:
    """The NVIDIA cards this process may open, counted without starting
    JAX's backend (initialize must come first): CUDA_VISIBLE_DEVICES when
    set, else `nvidia-smi -L`. None when there are none, or when
    JAX_PLATFORMS holds JAX to another platform."""
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not {"cuda", "gpu"} & set(platforms.split(",")):
        return None
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        n = len([v for v in visible.split(",") if v.strip()])
    else:
        try:
            smi = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            return None
        n = sum(line.startswith("GPU ") for line in smi.stdout.splitlines())
    return n or None


def local_devices_for(coordinator: Optional[str],
                      num_processes: Optional[int],
                      process_id: Optional[int],
                      n_cards: Optional[int]) -> Optional[list]:
    """This process's share of the host's `n_cards` cards when every
    process of the cluster runs on this host (coordinator on localhost);
    None (all local devices) otherwise."""
    if coordinator is None or not num_processes or num_processes < 2:
        return None
    if process_id is None or not n_cards:
        return None
    if coordinator.rsplit(":", 1)[0] not in _LOCAL_HOSTS:
        return None
    if n_cards % num_processes:
        raise ValueError(
            f"{num_processes} processes cannot split this host's {n_cards} "
            f"cards evenly: launch a divisor of {n_cards} processes, or set "
            f"JAX_LOCAL_DEVICE_IDS in each"
        )
    k = n_cards // num_processes
    return list(range(process_id * k, (process_id + 1) * k))


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Idempotent jax.distributed.initialize.

    With no arguments: initializes only when the environment declares a
    cluster (coordinator env vars) and otherwise runs single-process — the
    common case. Processes sharing this host split its cards
    (local_devices_for). With explicit arguments, or with a cluster
    environment present, a failed init is FATAL: a configured
    distributed job must never silently degrade to a single-host render
    with every host writing artifacts (the reference's analog is its
    fail-fast exit(0) on OpenCL errors, global_illumination_cl.c:227-242).
    """
    global _initialized
    if _initialized:
        return
    explicit = coordinator is not None or num_processes is not None
    if not explicit and not cluster_configured():
        _initialized = True
        return
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if not os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        cards = local_devices_for(coordinator, num_processes, process_id,
                                  host_card_count())
        if cards is not None:
            kwargs["local_device_ids"] = cards
    # NOTE: must run before ANY other jax call — even jax.process_count()
    # initializes the XLA backend and would make this raise.
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        msg = str(e).lower()
        if "already initialized" in msg or "only be called once" in msg:
            # auto-init by the runtime (or a second initialize() call
            # path). jax 0.9's double-init text is "distributed.initialize
            # should only be called once."; older versions said "already
            # initialized" — match both.
            _initialized = True
            info(f"distributed runtime already up ({e})")
            return
        if not explicit and "before any jax calls" in msg:
            # env-triggered auto-init attempted after JAX was already up
            # (e.g. library use inside a larger program): stay single-host
            from ..utils.progress import warn

            _initialized = True
            warn(f"distributed auto-init skipped: {e}")
            return
        raise RuntimeError(
            "jax.distributed.initialize failed for a configured cluster "
            f"(coordinator={coordinator!r}): {e}"
        ) from e
    _initialized = True
    info(
        f"distributed runtime up: process {jax.process_index()}/"
        f"{jax.process_count()}, {jax.local_device_count()} local / "
        f"{jax.device_count()} global devices"
    )


def is_primary() -> bool:
    """True on the host that should write artifacts (tiles, JSONs)."""
    return jax.process_index() == 0
