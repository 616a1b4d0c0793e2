"""Wrappers of the hand-written Hopper kernels.

A tensor on the CPU takes the plain version from ``kernels/ref.py``. A CUDA
tensor launches the kernel from ``csrc/`` or raises: there is no fallback
and no switch. A fake tensor (``FakeTensorMode``: a dry run traces shapes,
on either device) computes nothing: the wrapper returns outputs of the
kernel's shapes and dtypes and reports the call's work
(``kernels/work.py``) to the counters that listen. Each wrapper checks device, dtype, shape and contiguity,
allocates the outputs, launches on PyTorch's current stream without
synchronising, raises if the launch reported an error, and then adds one
to its ``launches`` count (a plain integer on the wrapper; CPU calls do not
count).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import ref, work
from repro_torch.kernels.build import library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh DType
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 64        # query heads per kv head the decode kernel takes
PREFILL_HEAD_DIMS = (64, 128)   # the prefill kernel's builds


def _traced(name: str, args, *outs):
    """A fake call: report its work, return the outputs' stand-ins."""
    work.report(name, *args)
    return outs if len(outs) > 1 else outs[0]


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(name: str, dtype: torch.dtype, device: torch.device,
           **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return _DTYPE_CODE[t.dtype]


def _head_dim(name: str, D: int) -> None:
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {_HEAD_DIMS}")


def _window(name: str, window: int) -> None:
    if window < 0:
        raise ValueError(f"{name}: negative window {window}")


def _aligned16(name: str, **tensors: torch.Tensor) -> None:
    """The decode kernels copy K/V rows in 16-byte pieces."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def shared_chunk_attention(qd: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, qmask: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """qd: (E, cap, H, D); k/v: (E, C, KH, D); qmask: (E, cap) bool.
    Returns (out (E, cap, H, D) in qd.dtype, lse (E, cap, H) fp32)."""
    if isinstance(qd, FakeTensor):
        return _traced("shared_chunk_attention", (qd, k, v, qmask),
                       torch.empty_like(qd), qd.new_empty(
                           qd.shape[:3], dtype=torch.float32))
    if _on_cpu(qd):
        return ref.shared_chunk_attention_ref(qd, k, v, qmask)
    name = "shared_chunk_attention"
    E, cap, H, D = qd.shape
    _, C, KH, _ = k.shape
    if k.shape != (E, C, KH, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"{name}: shapes qd {tuple(qd.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if qmask.shape != (E, cap):
        raise ValueError(f"{name}: qmask {tuple(qmask.shape)} != {(E, cap)}")
    _head_dim(name, D)
    code = _code(name, qd)
    _check(name, qd.dtype, qd.device, qd=qd, k=k, v=v)
    _check(name, torch.bool, qd.device, qmask=qmask)
    out = torch.empty_like(qd)
    lse = torch.empty((E, cap, H), dtype=torch.float32, device=qd.device)
    if out.numel() == 0 or C == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_shared_chunk_attn(
        _ptr(qd), _ptr(k), _ptr(v), _ptr(qmask), _ptr(out), _ptr(lse),
        E, cap, H, KH, D, C, code, _stream()))
    shared_chunk_attention.launches += 1
    return out, lse


def shared_chunk_attention_q8(qd: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, qmask: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``shared_chunk_attention`` over an int8 store, dequantized in the
    kernel. qd: (E, cap, H, D) fp32 or bf16; k/v: (E, C, KH, D) int8;
    k_scale/v_scale: (E, C, KH) fp32; qmask: (E, cap) bool. Returns (out
    (E, cap, H, D) in qd.dtype, lse (E, cap, H) fp32)."""
    if isinstance(qd, FakeTensor):
        return _traced("shared_chunk_attention_q8",
                       (qd, k, v, k_scale, v_scale, qmask),
                       torch.empty_like(qd), qd.new_empty(
                           qd.shape[:3], dtype=torch.float32))
    if _on_cpu(qd):
        return ref.shared_chunk_attention_q8_ref(qd, k, v, k_scale, v_scale,
                                                 qmask)
    name = "shared_chunk_attention_q8"
    E, cap, H, D = qd.shape
    _, C, KH, _ = k.shape
    if k.shape != (E, C, KH, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"{name}: shapes qd {tuple(qd.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k_scale.shape != (E, C, KH) or v_scale.shape != k_scale.shape:
        raise ValueError(f"{name}: scales {tuple(k_scale.shape)} "
                         f"{tuple(v_scale.shape)} != {(E, C, KH)}")
    if qmask.shape != (E, cap):
        raise ValueError(f"{name}: qmask {tuple(qmask.shape)} != {(E, cap)}")
    _head_dim(name, D)
    code = _code(name, qd)
    _check(name, qd.dtype, qd.device, qd=qd)
    _check(name, torch.int8, qd.device, k=k, v=v)
    _check(name, torch.float32, qd.device, k_scale=k_scale, v_scale=v_scale)
    _check(name, torch.bool, qd.device, qmask=qmask)
    out = torch.empty_like(qd)
    lse = torch.empty((E, cap, H), dtype=torch.float32, device=qd.device)
    if out.numel() == 0 or C == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_shared_chunk_attn_q8(
        _ptr(qd), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale),
        _ptr(qmask), _ptr(out), _ptr(lse), E, cap, H, KH, D, C, code,
        _stream()))
    shared_chunk_attention_q8.launches += 1
    return out, lse


def shared_tail_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, first: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every row against one shared tail of keys: q (N, H, D) bf16; k/v
    (T, KH, D) bf16; first (N,) int32, row n's first visible key (keys
    first[n] .. T - 1 count). Returns (out (N, H, D) bf16, lse (N, H)
    fp32); a row that sees no key gets out 0 and lse -inf."""
    if isinstance(q, FakeTensor):
        return _traced("shared_tail_attention", (q, k, v, first),
                       torch.empty_like(q), q.new_empty(
                           q.shape[:2], dtype=torch.float32))
    if _on_cpu(q):
        return ref.shared_tail_attention_ref(q, k, v, first)
    name = "shared_tail_attention"
    N, H, D = q.shape
    T, KH = k.shape[0], k.shape[1]
    if k.shape != (T, KH, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if first.shape != (N,):
        raise ValueError(f"{name}: first {tuple(first.shape)} != {(N,)}")
    if D not in PREFILL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {PREFILL_HEAD_DIMS}")
    _check(name, torch.bfloat16, q.device, q=q, k=k, v=v)
    _check(name, torch.int32, q.device, first=first)
    if N == 0 or T == 0:
        raise ValueError(f"{name}: empty input")
    _aligned16(name, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((N, H), dtype=torch.float32, device=q.device)
    _raise_on(name, library().moska_shared_tail_attn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(first), _ptr(out), _ptr(lse),
        N, H, KH, D, T, _stream()))
    shared_tail_attention.launches += 1
    return out, lse


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, H, D); k/v: (B, S, KH, D); kv_len: (B,) int32; ``window > 0``
    attends only the last ``window`` of each request's ``kv_len`` positions.
    Returns (out (B, H, D) in q.dtype, lse (B, H) fp32)."""
    if isinstance(q, FakeTensor):
        return _traced("decode_attention", (q, k, v, kv_len, window),
                       torch.empty_like(q),
                       q.new_empty(q.shape[:2], dtype=torch.float32))
    if _on_cpu(q):
        return ref.decode_attention_ref(q, k, v, kv_len, window=window)
    name = "decode_attention"
    _window(name, window)
    B, H, D = q.shape
    _, S, KH, _ = k.shape
    if k.shape != (B, S, KH, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if H // KH > _MAX_GROUP:
        raise ValueError(f"{name}: {H // KH} query heads per kv head > "
                         f"{_MAX_GROUP}")
    if kv_len.shape != (B,):
        raise ValueError(f"{name}: kv_len {tuple(kv_len.shape)} != {(B,)}")
    _head_dim(name, D)
    code = _code(name, q)
    _check(name, q.dtype, q.device, q=q, k=k, v=v)
    _check(name, torch.int32, q.device, kv_len=kv_len)
    _aligned16(name, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_decode_attn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(kv_len), _ptr(out), _ptr(lse),
        B, H, KH, D, S, window, code, _stream()))
    decode_attention.launches += 1
    return out, lse


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor, window: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention`` with the K/V in a page pool. q: (B, H, D);
    k_pool/v_pool: (N, bs, KH, D); table: (B, M) int32 page ids in
    [0, N); kv_len: (B,) int32; ``window > 0`` attends only the last
    ``window`` positions. Returns (out (B, H, D) in q.dtype, lse (B, H)
    fp32)."""
    if isinstance(q, FakeTensor):
        return _traced("paged_decode_attention",
                       (q, k_pool, v_pool, table, kv_len, window),
                       torch.empty_like(q),
                       q.new_empty(q.shape[:2], dtype=torch.float32))
    if _on_cpu(q):
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, table,
                                              kv_len, window=window)
    name = "paged_decode_attention"
    _window(name, window)
    B, H, D = q.shape
    N, bs, KH, _ = k_pool.shape
    if k_pool.shape != (N, bs, KH, D) or v_pool.shape != k_pool.shape \
            or H % KH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k_pool {tuple(k_pool.shape)} "
                         f"v_pool {tuple(v_pool.shape)}")
    if H // KH > _MAX_GROUP:
        raise ValueError(f"{name}: {H // KH} query heads per kv head > "
                         f"{_MAX_GROUP}")
    if table.dim() != 2 or table.shape[0] != B or table.shape[1] < 1:
        raise ValueError(f"{name}: table {tuple(table.shape)} is not "
                         f"({B}, M >= 1)")
    if kv_len.shape != (B,):
        raise ValueError(f"{name}: kv_len {tuple(kv_len.shape)} != {(B,)}")
    _head_dim(name, D)
    code = _code(name, q)
    _check(name, q.dtype, q.device, q=q, k_pool=k_pool, v_pool=v_pool)
    _check(name, torch.int32, q.device, table=table, kv_len=kv_len)
    _aligned16(name, k_pool=k_pool, v_pool=v_pool)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_paged_decode_attn(
        _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(table), _ptr(kv_len),
        _ptr(out), _ptr(lse), B, H, KH, D, bs, table.shape[1], window,
        code, _stream()))
    paged_decode_attention.launches += 1
    return out, lse


def lse_merge(outs: torch.Tensor, lses: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """outs: (P, N, H, D); lses: (P, N, H) fp32 -> (out (N, H, D) in
    outs.dtype, lse (N, H) fp32)."""
    if isinstance(outs, FakeTensor):
        return _traced("lse_merge", (outs, lses), torch.empty_like(outs[0]),
                       torch.empty_like(lses[0]))
    if _on_cpu(outs):
        return ref.lse_merge_ref(outs, lses)
    name = "lse_merge"
    P, N, H, D = outs.shape
    if lses.shape != (P, N, H):
        raise ValueError(f"{name}: lses {tuple(lses.shape)} != {(P, N, H)}")
    code = _code(name, outs)
    _check(name, outs.dtype, outs.device, outs=outs)
    _check(name, torch.float32, outs.device, lses=lses)
    out = torch.empty((N, H, D), dtype=outs.dtype, device=outs.device)
    lse = torch.empty((N, H), dtype=torch.float32, device=outs.device)
    if out.numel() == 0 or P == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_lse_merge(
        _ptr(outs), _ptr(lses), _ptr(out), _ptr(lse), P, N * H, D, code,
        _stream()))
    lse_merge.launches += 1
    return out, lse


def lse_merge_pair(o0: torch.Tensor, l0: torch.Tensor, o1: torch.Tensor,
                   l1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lse_merge`` of two partials that lie apart, partial 0 first: the
    same kernel body, with no stacked copy. o0/o1: (N, H, D); l0/l1: (N, H)
    fp32 -> (out (N, H, D) in o0.dtype, lse (N, H) fp32). Counts as an
    ``lse_merge`` launch."""
    if isinstance(o0, FakeTensor):
        return _traced("lse_merge_pair", (o0, l0, o1, l1),
                       torch.empty_like(o0), torch.empty_like(l0))
    if _on_cpu(o0):
        return ref.lse_merge_pair_ref(o0, l0, o1, l1)
    name = "lse_merge_pair"
    N, H, D = o0.shape
    if o1.shape != o0.shape or l0.shape != (N, H) or l1.shape != (N, H):
        raise ValueError(f"{name}: shapes o0 {tuple(o0.shape)} "
                         f"o1 {tuple(o1.shape)} l0 {tuple(l0.shape)} "
                         f"l1 {tuple(l1.shape)}")
    code = _code(name, o0)
    _check(name, o0.dtype, o0.device, o0=o0, o1=o1)
    _check(name, torch.float32, o0.device, l0=l0, l1=l1)
    out = torch.empty_like(o0)
    lse = torch.empty((N, H), dtype=torch.float32, device=o0.device)
    if out.numel() == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_lse_merge_pair(
        _ptr(o0), _ptr(l0), _ptr(o1), _ptr(l1), _ptr(out), _ptr(lse), N * H,
        D, code, _stream()))
    lse_merge.launches += 1
    return out, lse


def lse_merge_routed(od: torch.Tensor, lsed: torch.Tensor, lin: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K-chunk merge of batched shared attention, reading the shared
    kernel's rows where they lie. od: (R, Q, H, D); lsed: (R, Q, H) fp32;
    lin: (G, K) int64, partial k of group g is row ``lin[g, k]``, and a row
    outside [0, R) (the dispatch's trash row) is an empty partial (out 0,
    lse -1e30). Returns (out (G * Q, H, D) in od.dtype, lse (G * Q, H)
    fp32). Counts as an ``lse_merge`` launch."""
    if isinstance(od, FakeTensor):
        G, Q = lin.shape[0], od.shape[1]
        return _traced("lse_merge_routed", (od, lsed, lin),
                       od.new_empty((G * Q, *od.shape[2:])),
                       lsed.new_empty((G * Q, od.shape[2])))
    if _on_cpu(od):
        return ref.lse_merge_routed_ref(od, lsed, lin)
    name = "lse_merge_routed"
    R, Q, H, D = od.shape
    if lsed.shape != (R, Q, H) or lin.dim() != 2:
        raise ValueError(f"{name}: shapes od {tuple(od.shape)} "
                         f"lsed {tuple(lsed.shape)} lin {tuple(lin.shape)}")
    G, K = lin.shape
    code = _code(name, od)
    _check(name, od.dtype, od.device, od=od)
    _check(name, torch.float32, od.device, lsed=lsed)
    _check(name, torch.int64, od.device, lin=lin)
    out = torch.empty((G * Q, H, D), dtype=od.dtype, device=od.device)
    lse = torch.empty((G * Q, H), dtype=torch.float32, device=od.device)
    if out.numel() == 0 or K == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_lse_merge_routed(
        _ptr(od), _ptr(lsed), _ptr(lin), _ptr(out), _ptr(lse), R, G, K,
        Q * H, D, code, _stream()))
    lse_merge.launches += 1
    return out, lse


def router_scores(q: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """q: (G, H, D); emb: (E, KH, D) -> scores (G, E) fp32."""
    if isinstance(q, FakeTensor):
        return _traced("router_scores", (q, emb), q.new_empty(
            (q.shape[0], emb.shape[0]), dtype=torch.float32))
    if _on_cpu(q):
        return ref.router_scores_ref(q, emb)
    name = "router_scores"
    G, H, D = q.shape
    E, KH, _ = emb.shape
    if emb.shape != (E, KH, D) or H % KH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"emb {tuple(emb.shape)}")
    code = _code(name, q)
    _check(name, q.dtype, q.device, q=q, emb=emb)
    out = torch.empty((G, E), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or H * D == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_router_scores(
        _ptr(q), _ptr(emb), _ptr(out), G, H, KH, D, E, code, _stream()))
    router_scores.launches += 1
    return out


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            q_offset: int = 0, kv_offset: int = 0,
                            kv_len=None, window: int = 0,
                            block_q: int = ref.FLASH_BLOCK,
                            block_k: int = ref.FLASH_BLOCK
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal (or not) attention of q (B, Sq, H, D) over k/v (B, Sk, KH,
    D), bf16: query i at position ``q_offset + i``, key j at ``kv_offset +
    j``, keys at or past ``kv_len`` (an int, or None for Sk) masked, a
    sliding ``window`` if > 0; ``block_q``/``block_k``: the plain
    version's blocks, which decide what a row with no valid key averages.
    Returns (out (B, Sq, H, D) bf16, lse (B, Sq, H) fp32)."""
    if isinstance(q, FakeTensor):
        return _traced("flash_prefill_attention",
                       (q, k, v, causal, q_offset, kv_offset, kv_len,
                        window), torch.empty_like(q),
                       q.new_empty(q.shape[:3], dtype=torch.float32))
    if _on_cpu(q):
        return ref.flash_prefill_attention_ref(q, k, v, causal, q_offset,
                                               kv_offset, kv_len, window,
                                               block_q, block_k)
    name = "flash_prefill_attention"
    _window(name, window)
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if k.shape != (B, Sk, KH, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in PREFILL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {PREFILL_HEAD_DIMS}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q is {q.dtype}, expected bfloat16")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"{name}: blocks {block_q}, {block_k}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(name, q.dtype, q.device, q=q, k=k, v=v)
    _aligned16(name, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or Sk == 0:
        raise ValueError(f"{name}: empty input")
    _raise_on(name, library().moska_flash_prefill_attn(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), B, Sq, Sk, H, KH,
        D, int(causal), int(q_offset), int(kv_offset),
        Sk if kv_len is None else int(kv_len), int(window), int(block_q),
        int(block_k), _stream()))
    flash_prefill_attention.launches += 1
    return out, lse


KERNELS = (shared_chunk_attention, decode_attention, lse_merge,
           router_scores, paged_decode_attention, shared_chunk_attention_q8,
           flash_prefill_attention, shared_tail_attention)
for _fn in KERNELS:
    _fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
