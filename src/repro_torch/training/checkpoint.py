"""Checkpointing: the port's parameters and AdamW state <-> .npz files in
the reference's layout.

Port of the reference ``training/checkpoint.py``: a ``step_XXXXXXXX``
directory written under a temporary name and renamed into place, a
``LATEST`` pointer beside it, and bf16 leaves stored as fp32 (npz has no
bf16). The npz keys and shapes are the reference's own: the pytree path
joined by ``/`` (the dense family's layers stacked into ``(L, ...)``
leaves; the optimizer's ``.step``, ``.mu/<path>`` and ``.nu/<path>``), so
a reference checkpoint restores into the port and a port checkpoint
restores in the reference.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.convert import reference_paths, to_reference_params
from repro_torch.training.optimizer import AdamWState


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/b/0/c": leaf} of a nested dict/list tree with numpy leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, np.ndarray] = {}
    for name, t in items:
        out.update(_flatten(t, f"{prefix}/{name}" if prefix else name))
    return out


def _ref_flat(params: nn.Module, values=None) -> Dict[str, np.ndarray]:
    return _flatten(to_reference_params(params, values,
                                        bf16_as_float32=True))


def save_checkpoint(ckpt_dir: str, step: int, params: nn.Module,
                    opt_state: Optional[AdamWState] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    np.savez(os.path.join(tmp, "params.npz"), **_ref_flat(params))
    if opt_state is not None:
        opt = {".step": np.asarray(opt_state.step, np.int32)}
        for field in ("mu", "nu"):
            for key, a in _ref_flat(params, getattr(opt_state,
                                                    field)).items():
                opt[f".{field}/{key}"] = a
        np.savez(os.path.join(tmp, "opt.npz"), **opt)
    meta = {"step": int(step), **(extra or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        raise FileExistsError(path)
    os.rename(tmp, path)
    # refresh "latest" pointer
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    return path if os.path.exists(path) else None


@torch.no_grad()
def _load(params: nn.Module, flat, prefix: str,
          dst: Dict[str, torch.Tensor]) -> None:
    """Copy npz leaves (keys ``prefix`` + the reference's path) into the
    tensors of ``dst`` (by parameter name), cast to their dtypes."""
    for name, path, row in reference_paths(params):
        key = "/".join(path)
        a = flat[prefix + key]
        t = dst[name]
        src = torch.from_numpy(np.ascontiguousarray(
            a if row is None else a[row]))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} != "
                             f"{tuple(t.shape)}")
        t.copy_(src.to(t.dtype))


def restore_checkpoint(path: str, params_template: nn.Module,
                       opt_template: Optional[AdamWState] = None
                       ) -> Tuple[int, nn.Module, Optional[AdamWState]]:
    """Load a checkpoint into ``params_template`` (and the moments of
    ``opt_template``) in place, each leaf cast to the template's dtype and
    kept on its device. Returns (step, params, opt state or None)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as pf:
        _load(params_template, pf, "",
              dict(params_template.named_parameters()))
    opt = None
    opt_path = os.path.join(path, "opt.npz")
    if opt_template is not None and os.path.exists(opt_path):
        with np.load(opt_path) as of:
            _load(params_template, of, ".mu/", opt_template.mu)
            _load(params_template, of, ".nu/", opt_template.nu)
            opt = AdamWState(int(of[".step"]), opt_template.mu,
                             opt_template.nu)
    return meta["step"], params_template, opt
