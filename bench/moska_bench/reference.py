"""What every architecture's plain reference (``bench/archs/<arch>/
reference.py``) shares: the float8 rounding of the control, TF32 products,
the top-k choice and its distance from a tie, and the capacities the
program configures for chunks and experts with the choices that find room.

Plain PyTorch: it imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim``, returned in float32."""
    t = t.float()
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def tf32():
    """TF32 matrix products for the reference's float32 work; the program's
    own float32 products run with the flag as it was."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def moe_capacity(rows: int, top_k: int, experts: int, factor: float) -> int:
    cap = int(math.ceil(rows * top_k * factor / experts))
    return min(max(8, int(math.ceil(cap / 8) * 8)), rows * top_k)


def chunk_capacity(groups: int, top_k: int, chunks: int,
                   factor: float) -> int:
    cap = int(math.ceil(groups * top_k / max(chunks, 1) * factor))
    cap = max(cap, min(groups, 8))
    return min(int(math.ceil(cap / 8) * 8), groups * top_k)


def first_slots(ids: torch.Tensor, n: int, capacity: int) -> torch.Tensor:
    """Which of the flattened choices ``ids`` (rows in order, each row's
    choices in order) find room: a choice keeps its place while fewer than
    ``capacity`` earlier choices went to the same destination."""
    flat = ids.reshape(-1)
    onehot = F.one_hot(flat, n)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(1)
    return (pos < capacity).view(ids.shape)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def margin(scores: torch.Tensor, k: int) -> torch.Tensor:
    """How far a top-k choice is from a tie, per row: the k-th score less
    the (k+1)-th, over the row's standard deviation (inf with no
    (k+1)-th)."""
    if scores.shape[-1] <= k:
        return torch.full(scores.shape[:-1], math.inf, device=scores.device)
    vals = torch.sort(scores, dim=-1, descending=True).values
    return (vals[..., k - 1] - vals[..., k]) / scores.std(dim=-1).clamp_min(
        1e-30)
