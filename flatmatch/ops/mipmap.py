"""In-arena mipmap pyramids over the flat texel array.

The reference builds each rect's pyramid with recursive in-place averaging
(/root/reference/rectangle.c:508-575): 2x2 averages while both dims > 1, pair
averages along the remaining dim otherwise, each level written directly after
its parent in the arena. Only radiosity rebuilds mipmaps per iteration
(radiosityNative.c:249-250).

Design: the recursion is compiled on the host into a per-level gather
plan (parent index, up-to-4 child indices, weights) shared by every rect.
Applying one plan level is a single gather + weighted sum + scatter — a shape
XLA handles well — and levels run in order because level L reads level L-1.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..scene.rectangle import Rect


class MipmapPlan(NamedTuple):
    """One entry per pyramid level (across all rects that have that level)."""

    parents: List[np.ndarray]   # per level: [P] int32 arena indices
    children: List[np.ndarray]  # per level: [P,4] int32 arena indices
    weights: List[np.ndarray]   # per level: [P,4] float32


def build_plan(rects: Sequence[Rect]) -> MipmapPlan:
    levels: List[dict] = []

    def level_slot(i):
        while len(levels) <= i:
            levels.append({"p": [], "c": [], "w": []})
        return levels[i]

    for r in rects:
        w, h = r.wtiles, r.htiles
        src_base = r.base
        level = 0
        while w > 1 or h > 1:
            dst_base = src_base + w * h
            slot = level_slot(level)
            if w > 1 and h > 1:
                tw, th = w // 2, h // 2
                for j in range(th):
                    for i in range(tw):
                        slot["p"].append(dst_base + j * tw + i)
                        slot["c"].append(
                            [
                                src_base + (2 * j) * w + 2 * i,
                                src_base + (2 * j + 1) * w + 2 * i,
                                src_base + (2 * j) * w + 2 * i + 1,
                                src_base + (2 * j + 1) * w + 2 * i + 1,
                            ]
                        )
                        slot["w"].append([0.25] * 4)
            else:
                # one dim collapsed: pair-average along the live dim
                # (mipmapInternalHorizontal, rectangle.c:508-533)
                n = w * h
                tw = n // 2
                for i in range(tw):
                    slot["p"].append(dst_base + i)
                    c0 = src_base + 2 * i
                    c1 = src_base + 2 * i + 1
                    slot["c"].append([c0, c1, c0, c1])
                    slot["w"].append([0.5, 0.5, 0.0, 0.0])
                w, h = (tw, 1) if w > 1 else (1, tw)
                src_base = dst_base
                level += 1
                continue
            w, h = tw, th
            src_base = dst_base
            level += 1

    return MipmapPlan(
        parents=[np.array(l["p"], np.int32) for l in levels],
        children=[np.array(l["c"], np.int32).reshape(-1, 4) for l in levels],
        weights=[np.array(l["w"], np.float32).reshape(-1, 4) for l in levels],
    )


def apply_plan(texels: jnp.ndarray, plan: MipmapPlan) -> jnp.ndarray:
    """Rebuild every pyramid level of `texels` [T,3] (or [T]) on device."""
    for p, c, w in zip(plan.parents, plan.children, plan.weights):
        if len(p) == 0:
            continue
        gathered = texels[c]  # [P,4,...]
        if texels.ndim == 2:
            avg = jnp.sum(gathered * w[..., None], axis=1)
        else:
            avg = jnp.sum(gathered * w, axis=1)
        texels = texels.at[p].set(avg)
    return texels


def apply_plan_np(texels: np.ndarray, plan: MipmapPlan) -> np.ndarray:
    """NumPy twin of apply_plan for the CPU oracle."""
    texels = texels.copy()
    for p, c, w in zip(plan.parents, plan.children, plan.weights):
        if len(p) == 0:
            continue
        gathered = texels[c]
        if texels.ndim == 2:
            texels[p] = np.sum(
                gathered * w[..., None], axis=1, dtype=np.float32
            )
        else:
            texels[p] = np.sum(gathered * w, axis=1, dtype=np.float32)
    return texels
