"""The chunk and expert choices the program makes in the checked wave, read
where it makes them, so that the judge can follow them and judge them by
how near to a tie they were rather than recompute them.

A top-k choice that sits near a tie flips between any two arithmetics,
and in a batch-coupled step one flip moves the capacity position of every
later slot that chose the same chunk or expert, so a recomputation that
makes its own choices disagrees with a sound program on many tokens. For
the one wave the judge checks, the engine's ``model.prefill`` (each
admission) and ``model.decode_step`` run with each function that the
architecture's ``program.py`` names in ``CHOICES`` (kind -> module,
attribute, the ids in what it returns) wrapped to keep the ids it returns,
layer by layer.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple

import torch

#: kind -> (module, attribute, the ids in the function's result)
Hooks = Dict[str, Tuple[str, str, Callable]]


class Choices:
    """Per call, per kind ("route", "expert"), the ids of each layer."""

    def __init__(self):
        self.calls: List[Dict[str, List[torch.Tensor]]] = []


def _recording(choices: Choices, hooks: Hooks, fn):
    def call(*args, **kwargs):
        got = {kind: [] for kind in hooks}
        orig = {}
        for kind, (module, attr, ids) in hooks.items():
            mod = importlib.import_module(module)
            orig[kind] = (mod, attr, getattr(mod, attr))

            def keep(*a, _f=orig[kind][2], _ids=ids, _got=got[kind], **k):
                out = _f(*a, **k)
                _got.append(_ids(out).detach().clone())
                return out
            setattr(mod, attr, keep)
        try:
            return fn(*args, **kwargs)
        finally:
            for mod, attr, f in orig.values():
                setattr(mod, attr, f)
            choices.calls.append(got)
    return call


def record_next_wave(engine, hooks: Hooks) -> Choices:
    """Keep the choices of the engine's model calls until ``stop``."""
    choices = Choices()
    model = engine.model
    model.prefill = _recording(choices, hooks, model.prefill)
    model.decode_step = _recording(choices, hooks, model.decode_step)
    return choices


def stop(engine) -> None:
    for name in ("prefill", "decode_step"):
        delattr(engine.model, name)
