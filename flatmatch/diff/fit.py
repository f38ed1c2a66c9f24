"""Inverse rendering: fit per-rect albedo and per-emitter power to a target
lightmap.

This is the consumer-facing loop over the replay-VJP renderers
(diff/render.py): given a target texel arena (e.g. a measured or
previously-rendered lightmap), recover the material/emitter parameters
that explain it by gradient descent. The reference renderer has no analog
(it is forward-only); this is the capability the differentiable
re-design exists for (BASELINE.md north-star: albedo/power gradients).

Parameterization keeps the optimization unconstrained:

  albedo = sigmoid(a_logit)   in (0, 1)  — physical reflectance range
  power  = exp(p_log)         in (0, ∞)  — multiplicative emitter scale

The renderer's RNG schedule is fixed by cfg.seed, so the loss is a
deterministic function of the parameters and the fit is exactly
reproducible (and when the target was rendered with the same seed, the
true parameters are an exact global optimum — gated in test_diff.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PhotonConfig
from ..ops.device_scene import EmittersDev, RectsDev


@dataclasses.dataclass
class FitResult:
    albedo: np.ndarray        # [N_rects] fitted reflectances in (0, 1)
    power: np.ndarray         # [N_emitters] fitted emitter scales (> 0)
    losses: np.ndarray        # [steps] relative-MSE loss per step
    lightmap: np.ndarray      # [T, 3] render at the fitted parameters


def _logit(x):
    x = jnp.clip(x, 1e-6, 1.0 - 1e-6)
    return jnp.log(x) - jnp.log1p(-x)


def make_renderer(
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
    mesh=None,
):
    """The replay-VJP renderer (diff/render.py), sharded over `mesh` when
    given."""
    from .render import make_diff_renderer, make_diff_renderer_sharded

    if mesh is not None:
        return make_diff_renderer_sharded(
            rects, emitters, num_texels, cfg, mesh
        )
    return make_diff_renderer(rects, emitters, num_texels, cfg)


def fit_materials(
    target,
    rects: RectsDev,
    emitters: EmittersDev,
    num_texels: int,
    cfg: PhotonConfig,
    *,
    mesh=None,
    steps: int = 100,
    learning_rate: float = 0.1,
    init_albedo: Optional[float] = None,
    init_power: float = 1.0,
    fit_albedo: bool = True,
    fit_power: bool = True,
) -> FitResult:
    """Gradient-descent fit of (albedo [N_rects], power [N_emitters]) to a
    target lightmap [num_texels, 3] (pre-exposure texel arena, the same
    quantity the renderers return).

    Loss = mean squared error relative to the target's mean square, so the
    result is exposure-scale-free. Optimizer: optax.adam. Parameters not
    being fit are held at their init. Deterministic for fixed cfg.seed.
    """
    import optax

    render = make_renderer(rects, emitters, num_texels, cfg, mesh=mesh)
    n_rects = int(rects.pos.shape[0])
    n_em = int(np.asarray(emitters.counts).shape[0])
    a0 = cfg.albedo if init_albedo is None else float(init_albedo)

    target = jnp.asarray(target, jnp.float32)
    norm = jnp.maximum(jnp.mean(target * target), 1e-20)

    params = {
        "a_logit": jnp.full((n_rects,), _logit(jnp.float32(a0)), jnp.float32),
        "p_log": jnp.full((n_em,), jnp.log(jnp.float32(init_power)),
                          jnp.float32),
    }

    def constrain(params):
        albedo = jax.nn.sigmoid(params["a_logit"])
        power = jnp.exp(params["p_log"])
        if not fit_albedo:
            albedo = jax.lax.stop_gradient(albedo)
        if not fit_power:
            power = jax.lax.stop_gradient(power)
        return albedo, power

    def loss_fn(params):
        albedo, power = constrain(params)
        lm = render(albedo, power)
        return jnp.mean((lm - target) ** 2) / norm

    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    # the whole fit as ONE device program: a lax.scan over steps instead
    # of a Python loop with a per-step host readback, and the losses come
    # back as a single [steps] array
    @functools.partial(jax.jit, static_argnames=("n_steps",))
    def run(params, opt_state, n_steps):
        def body(carry, _):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=n_steps
        )
        return params, losses

    params, losses = run(params, opt_state, int(steps))
    losses = np.asarray(losses, np.float64)

    albedo, power = constrain(params)
    lightmap = render(albedo, power)
    return FitResult(
        albedo=np.asarray(albedo),
        power=np.asarray(power),
        losses=losses,
        lightmap=np.asarray(lightmap),
    )


def fit_layout(
    layout_png: str,
    target_dir: str,
    scale: float,
    cfg,
    *,
    mesh=None,
    steps: int = 100,
    learning_rate: float = 0.1,
    fit_albedo: bool = True,
    fit_power: bool = True,
    init_albedo: Optional[float] = None,
    init_power: float = 1.0,
    out_path: Optional[str] = None,
    render_out: Optional[str] = None,
) -> FitResult:
    """End-to-end inverse rendering from a rendered target on disk.

    `target_dir` holds `tile_<i>.raw` float32 dumps (one per wall, in wall
    order — the output of `render --dump-raw`, post-exposure radiance like
    the reference's saveAsRaw). The dumps are assembled into a texel
    arena, un-exposed back to raw engine radiance, and fit with
    fit_materials on the photon config in `cfg` (a RenderConfig).
    Writes a JSON report to `out_path` when given; `render_out` also
    exports tone-mapped tiles of the render at the fitted parameters
    (same export pipeline as `render`, for eyeballing the fit).
    """
    import json
    import pathlib

    from ..ops.device_scene import exposure_scale, pack_emitters, pack_rects
    from ..io.tiles import load_tile_raw
    from ..render import compile_scene
    from ..scene.rectangle import num_tiles

    scene, _ = compile_scene(layout_png, scale, cfg)
    tdir = pathlib.Path(target_dir)
    arena = np.zeros((scene.num_texels, 3), np.float32)
    for i, r in enumerate(scene.walls):
        meta, data = load_tile_raw(str(tdir / f"tile_{i}.raw"))
        if (meta["wtiles"], meta["htiles"]) != (r.wtiles, r.htiles):
            raise ValueError(
                f"tile_{i}.raw is {meta['wtiles']}x{meta['htiles']} but the "
                f"compiled scene's wall {i} is {r.wtiles}x{r.htiles} — was "
                f"the target rendered from this layout at this scale?"
            )
        arena[r.base : r.base + num_tiles(r)] = data.reshape(-1, 3)

    # undo the photon exposure normalization (main.c:68-79): the diff
    # renderers operate on raw pre-exposure radiance
    es = exposure_scale(
        scene, cfg.photon.samples_per_area, cfg.photon.exposure
    )
    lit = es > 0
    arena[lit] /= es[lit, None]

    rects = pack_rects(scene.walls)
    emitters = pack_emitters(
        scene,
        cfg.photon.samples_per_area,
        cfg.photon.window_color,
        cfg.photon.light_color,
    )
    res = fit_materials(
        arena, rects, emitters, scene.num_texels, cfg.photon,
        mesh=mesh, steps=steps, learning_rate=learning_rate,
        fit_albedo=fit_albedo, fit_power=fit_power,
        init_albedo=init_albedo, init_power=init_power,
    )
    if render_out is not None:
        from ..io.tiles import save_tiles

        fitted = res.lightmap * np.asarray(es)[:, None]
        save_tiles(scene.walls, fitted, render_out, tint_extra=False)
    if out_path is not None:
        pathlib.Path(out_path).write_text(json.dumps(
            {
                "albedo": [round(float(a), 6) for a in res.albedo],
                "power": [round(float(p), 6) for p in res.power],
                "initial_loss": res.losses[0] if len(res.losses) else None,
                "final_loss": res.losses[-1] if len(res.losses) else None,
                "steps": int(steps),
            },
            indent=1,
        ))
    return res
