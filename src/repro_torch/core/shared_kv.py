"""Shared KV chunk store — the persistent, massively-reused corpus KV.

Port of the reference ``core/shared_kv.py``. Layout (stacked over layers;
the decoder loop takes one slice per layer):
    k, v : (L, n_chunks, chunk_size, kv_heads, head_dim)   post-RoPE keys
    emb  : (L, n_chunks, kv_heads, head_dim)               router embeddings

A model whose layers differ in their window (afmoe's sliding-window and
full layers) keeps a ``LayeredStore``: per layer, a full layer's chunks as
above, and a sliding layer's one "chunk" of the document's last
``window - 1`` keys, the only ones its window can reach, with its mean
key. The layer lists index as the stacked tensors do (``k[i]``, ``v[i]``,
``emb[i]``).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class SharedKVStore(NamedTuple):
    k: torch.Tensor            # (L, E, C, KH, D), or int8 when quantized
    v: torch.Tensor            # (L, E, C, KH, D)
    emb: torch.Tensor          # (L, E, KH, D) mean-key chunk embeddings
    # absolute corpus position of the first token of each chunk
    chunk_positions: torch.Tensor    # (E,) int32
    # int8 scales per (layer, chunk, token, kv head); None => unquantized
    k_scale: Optional[torch.Tensor] = None   # (L, E, C, KH) f32
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def dequantize_layer(self, i: int):
        """Return (k, v) of layer i in compute dtype (bf16 when quantized)."""
        if not self.quantized:
            return self.k[i], self.v[i]
        bf = torch.bfloat16
        k = self.k[i].to(bf) * self.k_scale[i][..., None].to(bf)
        v = self.v[i].to(bf) * self.v_scale[i][..., None].to(bf)
        return k, v

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.k.shape[1]

    @property
    def chunk_size(self) -> int:
        return self.k.shape[2]

    @property
    def total_tokens(self) -> int:
        return self.num_chunks * self.chunk_size

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self
                   if t is not None)

    def layer(self, i: int) -> "SharedKVStore":
        return SharedKVStore(self.k[i], self.v[i], self.emb[i],
                             self.chunk_positions)


def abstract_store(cfg, shared_tokens: int, dtype=torch.bfloat16,
                   device=None) -> SharedKVStore:
    """The store of ``shared_tokens`` corpus tokens of ``cfg``'s attention
    layers as fake tensors (no allocation; the dry run's stand-in): int8
    K/V with fp32 scales under ``kv_quant="int8"``."""
    from repro_torch.sharding.tensor_parallel import fake_tensors
    C = cfg.moska.chunk_size
    E = shared_tokens // C
    L = cfg.num_attention_layers
    KH, D = cfg.num_kv_heads, cfg.head_dim
    quant = cfg.moska.kv_quant == "int8"
    kv = torch.int8 if quant else dtype
    with fake_tensors():
        def t(shape, dt):
            return torch.empty(shape, dtype=dt, device=device)
        return SharedKVStore(
            t((L, E, C, KH, D), kv), t((L, E, C, KH, D), kv),
            t((L, E, KH, D), dtype), t((E,), torch.int32),
            t((L, E, C, KH), torch.float32) if quant else None,
            t((L, E, C, KH), torch.float32) if quant else None)


def chunk_embeddings(k_chunks: torch.Tensor) -> torch.Tensor:
    """Training-free router embeddings: mean key per chunk.

    k_chunks: (..., E, C, KH, D) -> (..., E, KH, D)
    """
    return k_chunks.float().mean(dim=-3).to(k_chunks.dtype)


def _quantize(x: torch.Tensor):
    """(..., D) -> int8 values + per-row f32 scale."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def build_store(k: torch.Tensor, v: torch.Tensor, chunk_size: int,
                start_position: int = 0,
                quantize: bool = False) -> SharedKVStore:
    """Chunk a (L, S, KH, D) corpus KV into a SharedKVStore.

    Keys are post-RoPE at absolute positions ``start_position + [0, S)``;
    S must be a multiple of chunk_size. The chunk views share k/v's memory.
    """
    L, S, KH, D = k.shape
    if S % chunk_size:
        raise ValueError(f"corpus length {S} not a multiple of chunk_size "
                         f"{chunk_size}")
    E = S // chunk_size
    kc = k.reshape(L, E, chunk_size, KH, D)
    vc = v.reshape(L, E, chunk_size, KH, D)
    emb = chunk_embeddings(kc)
    pos = start_position + torch.arange(E, dtype=torch.int32,
                                        device=k.device) * chunk_size
    if not quantize:
        return SharedKVStore(kc, vc, emb, pos)
    kq, ks = _quantize(kc)
    vq, vs = _quantize(vc)
    return SharedKVStore(kq, vq, emb, pos, ks, vs)


class LayeredStore:
    """A store whose layers differ: per layer i, ``k[i]``/``v[i]`` (E_i,
    C_i, KH, D) and ``emb[i]`` (E_i, KH, D); a full layer's E_i chunks of
    ``chunk_size``, a sliding layer's one of its tail (``is_tail``)."""

    def __init__(self, k: List[torch.Tensor], v: List[torch.Tensor],
                 emb: List[torch.Tensor], chunk_positions: torch.Tensor,
                 windows: Sequence[int], total_tokens: int):
        self.k, self.v, self.emb = k, v, emb
        self.chunk_positions = chunk_positions
        self.windows = tuple(windows)
        self.total_tokens = total_tokens

    def is_tail(self, i: int) -> bool:
        return self.windows[i] > 0

    @property
    def num_layers(self) -> int:
        return len(self.k)

    @property
    def num_chunks(self) -> int:
        return self.chunk_positions.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (*self.k, *self.v, *self.emb))


def build_layered_store(k: torch.Tensor, v: torch.Tensor, chunk_size: int,
                        windows: Sequence[int],
                        start_position: int = 0) -> LayeredStore:
    """Chunk a (L, S, KH, D) corpus KV layer by layer: a full layer
    (window 0) into its S / chunk_size chunks, a sliding layer of window W
    into its last min(W - 1, S) positions. Each piece is a copy, so the
    corpus KV it came from can be freed."""
    L, S, KH, D = k.shape
    if S % chunk_size:
        raise ValueError(f"corpus length {S} not a multiple of chunk_size "
                         f"{chunk_size}")
    ks, vs, embs = [], [], []
    for i, w in enumerate(windows):
        if w:
            n = min(w - 1, S)
            kc = k[i, S - n:].clone()[None]
            vc = v[i, S - n:].clone()[None]
        else:
            kc = k[i].reshape(S // chunk_size, chunk_size, KH, D).clone()
            vc = v[i].reshape(S // chunk_size, chunk_size, KH, D).clone()
        ks.append(kc)
        vs.append(vc)
        embs.append(chunk_embeddings(kc))
    pos = start_position + torch.arange(S // chunk_size, dtype=torch.int32,
                                        device=k.device) * chunk_size
    return LayeredStore(ks, vs, embs, pos, windows, S)
