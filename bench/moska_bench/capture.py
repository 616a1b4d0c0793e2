"""The chunk and expert choices the program makes in the checked wave, read
where it makes them, so that the judge can follow them and judge them by
how near to a tie they were rather than recompute them.

A top-k choice that sits near a tie flips between any two arithmetics,
and in a batch-coupled step one flip moves the capacity position of every
later slot that chose the same chunk or expert, so a recomputation that
makes its own choices disagrees with a sound program on many tokens. For
the one wave the judge checks, the engine's ``model.prefill`` (each
admission) and ``model.decode_step`` run with ``repro_torch.core.router.
route`` and ``repro_torch.models.moe.top_k`` (the names the model calls)
wrapped to keep the ids they return, layer by layer.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class Choices:
    """Per call, per kind ("route", "expert"), the ids of each layer."""

    def __init__(self):
        self.calls: List[Dict[str, List[torch.Tensor]]] = []


def _recording(choices: Choices, fn):
    from repro_torch.core import router
    from repro_torch.models import moe

    def call(*args, **kwargs):
        got = {"route": [], "expert": []}
        route0, topk0 = router.route, moe.top_k

        def route(*a, **k):
            out = route0(*a, **k)
            got["route"].append(out.chunk_ids.detach().clone())
            return out

        def topk(scores, k):
            vals, ids = topk0(scores, k)
            got["expert"].append(ids.detach().clone())
            return vals, ids
        router.route, moe.top_k = route, topk
        try:
            return fn(*args, **kwargs)
        finally:
            router.route, moe.top_k = route0, topk0
            choices.calls.append(got)
    return call


def record_next_wave(engine) -> Choices:
    """Keep the choices of the engine's model calls until ``stop``."""
    choices = Choices()
    model = engine.model
    model.prefill = _recording(choices, model.prefill)
    model.decode_step = _recording(choices, model.decode_step)
    return choices


def stop(engine) -> None:
    for name in ("prefill", "decode_step"):
        delattr(engine.model, name)
