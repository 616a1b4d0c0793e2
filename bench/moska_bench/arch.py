"""A configuration's architecture, found by file.

The configuration's ``"reference"`` key names its plain reference,
``bench/archs/<arch>/reference.py``, relative to the checkout's root. The
same directory holds the other two files of the architecture:

- ``layout.py`` (nothing of the program): ``leaves(m)`` and ``groups(m)``,
  the weight leaves and their scale groups (``weights.make_weights``);
  ``prefill(m, prompt, chunks)`` and ``decode(m, context, chunks)``, the
  model FLOPs of a step (``loop.py``, ``mfu_pct``); ``batch_coupled(m,
  chunks)``, whether a decode step ties each slot to the others.
- ``program.py``: ``program_config(spec)`` and ``program_params(cfg,
  weights)``, the program under test built on the benchmark's weights;
  ``CHOICES``, where the program makes the choices the judge follows
  (``capture.py``).
- ``reference.py`` (nothing of the program): ``Reference``, which the judge
  (``check.judge``) runs, and its ``Store``.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from moska_bench.record import load_module


@dataclass(frozen=True)
class Arch:
    layout: ModuleType
    program: ModuleType
    reference: ModuleType


def load(spec: dict, root: Path) -> Arch:
    """The architecture of the configuration ``spec``, from the checkout at
    ``root``; a configuration that names none, or a file that is missing,
    fails here with the configuration's name."""
    name = spec.get("name", "?")
    rel = spec.get("reference")
    if not rel:
        raise KeyError(f"configuration {name!r} names no \"reference\" "
                       "(bench/archs/<arch>/reference.py)")
    ref = Path(root) / rel
    files = {"layout": ref.with_name("layout.py"),
             "program": ref.with_name("program.py"), "reference": ref}
    for kind, path in files.items():
        if not path.is_file():
            raise FileNotFoundError(f"configuration {name!r}: no {kind} "
                                    f"file {path} (its reference: {rel!r})")
    return Arch(**{k: load_module(p, "bench_arch_")
                   for k, p in files.items()})
