"""Compiled scenes from rect dumps.

A rect dump (tests/fixtures/*_rects.txt) is the reference scene compiler's
output written from a reference build: a header line with the group counts,
the texel total, the layout size and the starting position, then one block
per group (walls, windows, lights, box) of full-precision float32 rows

    pos[3] width[3] height[3] n[3] base wtiles htiles

(lightmapSetup, parseLayout.c:512-517). Loading one rebuilds the exact
Scene the layout PNG would compile to, which is how the flagship scene
(example.png, whose image is not shipped) reaches the engines.
"""
from __future__ import annotations

import pathlib

import numpy as np

from .geometry import Scene
from .layout import ParsedLayout
from .rectangle import Rect

f32 = np.float32


def parse_rect_dump(path):
    """(header dict, {group name: [row dict]}) of a rect dump."""
    groups = {}
    header = {}
    cur = None
    for line in pathlib.Path(path).read_text().splitlines():
        if line.startswith("# counts"):
            for tok in line.split()[2:]:
                k, v = tok.split("=")
                if k == "size":
                    header["width"], header["height"] = map(int, v.split("x"))
                elif k == "start":
                    header["start"] = tuple(f32(t) for t in v.split(","))
                else:
                    header[k] = int(v)
        elif line.startswith("# "):
            name, _ = line[2:].split()
            cur = []
            groups[name] = cur
        elif line.strip():
            vals = line.split()
            cur.append(
                dict(
                    pos=np.array(vals[0:3], f32),
                    width=np.array(vals[3:6], f32),
                    height=np.array(vals[6:9], f32),
                    n=np.array(vals[9:12], f32),
                    base=int(vals[12]),
                    wtiles=int(vals[13]),
                    htiles=int(vals[14]),
                )
            )
    return header, groups


def load_rect_dump(path) -> Scene:
    """The compiled Scene a rect dump describes."""
    header, groups = parse_rect_dump(path)

    def rects(name):
        rows = groups.get(name, [])
        if len(rows) != header.get(name, len(rows)):
            raise ValueError(
                f"{path}: header says {header[name]} {name}, found "
                f"{len(rows)}"
            )
        return [Rect(**row) for row in rows]

    lay = ParsedLayout(
        walls=rects("walls"),
        windows=rects("windows"),
        lights=rects("lights"),
        box=rects("box"),
        width=header["width"],
        height=header["height"],
        starting_position=header["start"],
        num_texels=header["texels"],
    )
    return Scene(lay)
