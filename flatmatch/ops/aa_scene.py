"""Axis-aligned scene packing for the photon trace kernel.

Everything the layout compiler emits is axis-aligned (SURVEY.md §1: the scene
is axis-aligned 3D rectangle geometry): wall spans and normals lie exactly on
coordinate axes, because parseLayout builds them from pixel-grid scans
(/root/reference/parseLayout.c:33-46, 375-491). An axis-aligned ray-rect test
needs ~1/3 the arithmetic of the general form: one reciprocal-multiply for
the plane hit plus two interval checks on the other two axes.

Rects are grouped by normal axis so the kernel can run one scalar rect loop
per group with the axis bound statically:

  axis 0 (normal +-x): span u along y, v along z   (vertical-scan walls)
  axis 1 (normal +-y): span u along x, v along z   (horizontal-scan walls)
  axis 2 (normal +-z): span u along x, v along y   (floors/ceilings/lights)

`pack_aa` returns None when any rect is not axis-aligned in this exact form;
such a scene renders on the general XLA engine (`photon_xla`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.rectangle import Rect

f32 = np.float32

# u/v coordinate axes per normal-axis group
GROUP_UV = {0: (1, 2), 1: (0, 2), 2: (0, 1)}

# scalar-field row layout of the [F_AA, N] matrix
A_O = 0      # plane offset pos[a]
A_SN = 1     # normal sign (+-1)
A_CU = 2     # span origin pos[au]
A_WS = 3     # width sign (+-1): du = (p_u - cu) * ws in [0, wlen]
A_WLEN = 4
A_CV = 5
A_HS = 6     # height sign
A_HLEN = 7
A_WT = 8     # tile grid width, as f32 (exact: grids are far below 2^24)
A_HT = 9
F_AA = 10


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["fields", "base"], meta_fields=["group_counts"],
)
@dataclasses.dataclass(frozen=True)
class AARectsDev:
    """Device arrays plus the static grouping (pytree metadata, so a jitted
    function taking the scene recompiles only when the grouping changes)."""

    fields: jnp.ndarray            # [F_AA, N] f32, rects grouped by axis
    base: jnp.ndarray              # [N] int32 texel arena base per slot
    group_counts: Tuple[int, int, int]  # rects per normal-axis group


def _classify(r: Rect):
    """(axis, au, av) or None if not axis-aligned.

    Off-axis components must be exactly (+-)0; the on-axis normal component
    may be ~1 ulp off exactly 1 (normalized_f32 of an axis vector rounds,
    e.g. 0.99999994) — the kernel uses the actual component values, so this
    costs no accuracy."""
    n = np.asarray(r.n, f32)
    a = int(np.argmax(np.abs(n)))
    au, av = GROUP_UV[a]
    if n[au] != 0.0 or n[av] != 0.0 or abs(n[a]) < 0.999999:
        return None
    w = np.asarray(r.width, f32)
    h = np.asarray(r.height, f32)
    # width must lie exactly on au, height on av
    if w[a] != 0.0 or w[av] != 0.0 or h[a] != 0.0 or h[au] != 0.0:
        return None
    if w[au] == 0.0 or h[av] == 0.0:
        return None
    return a, au, av


def pack_aa(rects: List[Rect]) -> Optional[AARectsDev]:
    from ..scene.rectangle import length_f32

    groups: List[List] = [[], [], []]
    group_src: List[List[int]] = [[], [], []]
    for ri, r in enumerate(rects):
        c = _classify(r)
        if c is None:
            return None
        a, au, av = c
        group_src[a].append(ri)
        w = np.asarray(r.width, f32)
        h = np.asarray(r.height, f32)
        wlen = length_f32(w)  # same value the general path uses
        hlen = length_f32(h)
        groups[a].append(
            [
                f32(r.pos[a]),
                f32(r.n[a]),            # actual (possibly 1-ulp-off) sign
                f32(r.pos[au]),
                f32(w[au] / wlen),      # == w_unit[au] of the general path
                wlen,
                f32(r.pos[av]),
                f32(h[av] / hlen),
                hlen,
                f32(r.wtiles),
                f32(r.htiles),
            ]
        )
    perm = group_src[0] + group_src[1] + group_src[2]
    rows = groups[0] + groups[1] + groups[2]
    fields = np.asarray(rows, f32).reshape(-1, F_AA).T.copy()  # [F_AA, N]
    return AARectsDev(
        fields=jnp.asarray(fields),
        base=jnp.asarray(np.asarray([rects[i].base for i in perm], np.int32)),
        group_counts=(len(groups[0]), len(groups[1]), len(groups[2])),
    )
