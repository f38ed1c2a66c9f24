"""Deposit splatting: the photon engines' one binning step.

Every engine produces a deposit stream of (texel id, rgb) rows, one per
photon and bounce (photonmap.cl:256-258 deposits in place with a racy
`lightColors[idx] += color`). XLA's scatter-add bins the stream; on the GPU
it runs as native atomic adds, so the float sum of a texel depends on the
order the adds land in and is not bit-reproducible there. On the CPU the
order is the stream order.
"""
from __future__ import annotations


def scatter_splat(lightmap, idx, col):
    """lightmap [T, 3] += deposits: ids [D, B] int32, colors [3, D, B].

    Out-of-range ids (the engines' DEAD id of a photon that left the scene
    or was masked) are dropped, not added: on the GPU they would otherwise
    pile their zero-color atomics onto one texel."""
    return lightmap.at[idx.reshape(-1)].add(
        col.reshape(3, -1).T, mode="drop"
    )
