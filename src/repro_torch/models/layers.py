"""Shared building blocks: norms, RoPE, attention, SwiGLU/GeGLU/GELU MLPs.

Port of the reference ``models/layers.py``. Parameters are mappings
(``nn.ParameterDict`` or plain dicts of tensors) with the reference names.
Activations keep the parameter dtype with fp32 softmax/norm accumulation.
``decode_attention`` and ``merge_partial_attention`` go through the
hand-written kernels (``repro_torch.kernels.ops``), and so does
``flash_attention`` where its inputs allow (the reference's is jnp code).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch import obs
from repro_torch.kernels import ops, ref
from repro_torch.sharding.specs import lsc
from repro_torch.sharding.tensor_parallel import split_heads

DEFAULT_BLOCK_K = DEFAULT_BLOCK_Q = ref.FLASH_BLOCK
NEG_INF = ref.NEG_INF
#: registry counters of ``flash_attention``'s calls, by who computed them
KERNEL_CALLS = "attn/prefill_kernel_calls"
PLAIN_CALLS = "attn/prefill_plain_calls"


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _ff_names(h: torch.Tensor):
    """The logical names of an FFN hidden (..., d_ff): its leading dims are
    the batch's rows (and their sequence). The reference names them None,
    which pins them replicated; on a mesh that would gather every rank's
    rows of the hidden over the data axis."""
    return ("batch", "seq")[:h.ndim - 1] + ("d_ff",)


def swiglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = lsc(h, *_ff_names(h))
    return h @ p["w_down"]


def geglu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    return (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    return gelu(x @ p["w_up"]) @ p["w_down"]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """fp32 logits (..., V) of hidden states (..., d) over a (V, d) table:
    the reference's ``preferred_element_type=float32`` unembedding."""
    return x.float() @ table.float().T


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C) with a (W, C) kernel and a (C,)
    bias: W - 1 zeros padded in front, the taps summed in order."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + S] * w[i][None, None]
               for i in range(W)) + b[None, None]


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split-half
    rotation (not interleaved)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def qkv_project(x: torch.Tensor, p, num_heads: int, num_kv_heads: int,
                head_dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (split_heads(q, num_heads, head_dim),
            split_heads(k, num_kv_heads, head_dim),
            split_heads(v, num_kv_heads, head_dim))


def _takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len) -> bool:
    """Whether the ``flash_prefill_attention`` kernel takes these inputs:
    CUDA tensors, q, k and v in bf16, a head dim it is built for, whole
    groups of query heads, no DTensor, no autograd, an int kv_len or
    none."""
    ts = (q, k, v)
    return (all(t.is_cuda and t.dtype == torch.bfloat16
                and not isinstance(t, DTensor) for t in ts)
            and q.shape[-1] in ops.PREFILL_HEAD_DIMS
            and q.shape[2] % k.shape[2] == 0
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts))
            and (kv_len is None or isinstance(kv_len, int)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_offset: int = 0, kv_len=None, window: int = 0,
                    block_k: int = DEFAULT_BLOCK_K,
                    block_q: int = DEFAULT_BLOCK_Q,
                    return_lse: bool = False):
    """Online-softmax attention of q (B, Sq, H, D) over k/v (B, Sk, KH, D):
    query i at position ``q_offset + i``, key j at ``kv_offset + j``, keys
    at or past ``kv_len`` masked, a sliding ``window`` if > 0. Same masks
    and arithmetic as the reference (finite -1e30 masking, p cast to
    v.dtype before PV, 1e-37 clamps); a row with no valid key averages
    the keys of the ``block_k`` blocks the loop visits for its ``block_q``
    block of queries.

    One algorithm, adapted by what the inputs show. The
    ``flash_prefill_attention`` kernel takes CUDA tensors with q, k and v
    in bf16, D in ``ops.PREFILL_HEAD_DIMS``, H a multiple of KH, no
    DTensor, no autograd (grad mode on with an input that requires grad)
    and an int kv_len or none: the admission prefills, prefill chunks and
    corpus registration. The blocked einsum
    (``ref.flash_prefill_attention_ref``) takes everything else: the CPU,
    fp32, the training step's autograd and other head dims. Each call adds
    one to the registry's ``attn/prefill_kernel_calls`` or
    ``attn/prefill_plain_calls``.
    """
    kernel = _takes_kernel(q, k, v, kv_len)
    obs.get_registry().inc(KERNEL_CALLS if kernel else PLAIN_CALLS)
    fn = (ops.flash_prefill_attention if kernel
          else ref.flash_prefill_attention_ref)
    out, lse = fn(q, k, v, causal, q_offset, kv_offset, kv_len, window,
                  block_q, block_k)
    return (out, lse) if return_lse else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: int = 0, return_lse: bool = False):
    """Single-token decode attention over the per-request (unique) cache:
    the paper's memory-bound GEMV path, through the ``decode_attention``
    kernel. q: (B, H, D); caches (B, S, KH, D); kv_len: (B,) int32."""
    out, lse = ops.decode_attention(q, k_cache, v_cache, kv_len,
                                    window=window)
    return (out, lse) if return_lse else out


def merge_partial_attention(outs, lses):
    """Exact merge of flash-decoding partials, through the ``lse_merge``
    kernel: lists of (..., H, D) outs and (..., H) lses. Two partials (the
    unique and the shared one of a MoSKA layer) go to its pair entry,
    which reads them where they lie; other counts are stacked."""
    shape = outs[0].shape
    o = [x.reshape(-1, *shape[-2:]).contiguous() for x in outs]
    l = [x.reshape(-1, shape[-2]).float().contiguous() for x in lses]
    if len(o) == 2:
        out, lse = ops.lse_merge_pair(o[0], l[0], o[1], l[1])
    else:
        out, lse = ops.lse_merge(torch.stack(o), torch.stack(l))
    return out.reshape(shape), lse.reshape(shape[:-1])


# ---------------------------------------------------------------------------
# training: rematerialization
# ---------------------------------------------------------------------------

#: matmuls without batch dimensions (JAX's
#: ``dots_with_no_batch_dims_saveable``): ``x @ W`` runs as ``mm``, while
#: attention's and the experts' batched products run as ``bmm``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn: Callable, policy: str = "nothing") -> Callable:
    """``fn`` under activation checkpointing: ``"nothing"`` saves only its
    inputs and recomputes the rest in the backward pass, ``"dots"`` also
    keeps the outputs of its unbatched matmuls, ``"none"`` returns ``fn``
    as it is (the reference's ``jax.checkpoint`` policies)."""
    if policy == "none":
        return fn
    if policy == "nothing":
        context_fn = ckpt.noop_context_fn
    elif policy == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    else:
        raise ValueError(f"remat policy {policy!r}: nothing | dots | none")

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)
    return wrapped
