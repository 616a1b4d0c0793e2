"""Seeded random weights, made on the device in a few large calls, and the
configuration file.

The architecture's layout (``bench/archs/<arch>/layout.py``) names every
leaf with its shape and scale group, and each group's standard deviation
and type. The leaves of a group lie in one buffer, in the served type (the
configuration's ``dtype``) unless the group is float32, filled by
``torch.randn`` in pieces of at most 2**30 elements and scaled by one
multiply; a group of deviation 0 is zeros. The groups are drawn in the
layout's order from one generator. The program's build (``program.py``)
points its parameters at views of these buffers; the reference gets the
same views as a plain dict.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import torch

PIECE = 1 << 30
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_spec(path: Path) -> dict:
    """The configuration file: the model's sizes under the program's field
    names, its provenance (source, reduced, assumed, deployment) and its
    architecture's reference (``reference``)."""
    return json.loads(Path(path).read_text())


def make_weights(spec: dict, layout, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout`` as a view of one buffer per scale group."""
    m = spec["model"]
    shapes = layout.leaves(m)
    served = DTYPES[m["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    groups = layout.groups(m)
    unknown = sorted({g for _, _, g in shapes} - set(groups))
    if unknown:
        raise KeyError(f"leaves of scale groups the layout has not: {unknown}")
    out: Dict[str, torch.Tensor] = {}
    for group, (std, fp32) in groups.items():
        leaves = [(n, s) for n, s, g in shapes if g == group]
        if not leaves:
            continue
        dt = torch.float32 if fp32 else served
        total = sum(math.prod(s) for _, s in leaves)
        buf = torch.empty(total, dtype=dt, device=device)
        if std:
            for a in range(0, total, PIECE):
                piece = buf[a:a + PIECE]
                torch.randn(piece.shape, generator=gen, dtype=dt,
                            device=device, out=piece)
            buf.mul_(std)
        else:
            buf.zero_()
        at = 0
        for name, s in leaves:
            n = math.prod(s)
            out[name] = buf[at:at + n].view(s)
            at += n
    return out
