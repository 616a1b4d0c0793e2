"""Dry-run specs: (architecture x input shape) -> a step function and its
arguments as fake ``DTensor`` values placed by the rules (no allocation).

Port of the reference ``launch/input_specs.py``, with its shapes, store
sizes, cache and store axes and skip reasons:

  train_4k     the train step (loss, gradients, AdamW), seq 4096, global
               batch 256
  prefill_32k  prefill, seq 32768, batch 32 (writes the unique cache)
  decode_32k   one decode step: a unique cache of 32768 per request, batch
               128, and a 2M-token shared store (MoSKA at decode)
  long_500k    one decode step over a 524288-token context, batch 1: for
               the dense family the context is the shared chunk store,
               attention MoSKA-routed; the SSM and hybrid decode with
               their O(1) state (a cache of the context's length, as the
               reference sizes it); whisper-tiny is skipped (no 500K
               decode analogue)

The arguments are the port's own leaves (the dense family's per-layer
parameters, the other families' ``ParamTree``, int64 tokens) on the mesh
given; each is a ``DTensor`` over fake tensors, so a full-size record
allocates nothing. Every family runs tensor parallel (the MoE layer
expert parallel in ``models/moe.py``; ``--variant expert_resident`` puts
the experts over ``data``). As the reference's, whisper-tiny's decode
reads its cross cache, without a store.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import get_config
from repro_torch.configs.base import (AUDIO, DENSE, INPUT_SHAPES, MOE,
                                      VLM, InputShape, ModelConfig)
from repro_torch.core.shared_kv import abstract_store
from repro_torch.models.model import build_model, empty_params
from repro_torch.sharding import specs as sp
from repro_torch.sharding.tensor_parallel import (fake_tensors, place,
                                                  place_fields)
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import (TrainLoopConfig,
                                             make_train_step, trainable)

# tokens in the attached shared store per shape (MoSKA-enabled archs)
DECODE32K_SHARED_TOKENS = 2 * 2**20     # 1024 x 2048-token chunks
LONG500K_UNIQUE_BUF = 2048              # generated-token buffer at 500K


@dataclass
class LoweringSpec:
    arch: str
    shape: str
    fn: Callable                     # positional-args step function
    args: Tuple[Any, ...]            # DTensor trees over fake tensors
    rules: sp.LogicalRules
    note: str = ""


class Skip(Exception):
    """(arch, shape) combination is intentionally unsupported."""


_CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # dense KVCache fields; seq dim over model = flash-decoding KV split
    "k": (None, "batch", "kv_seq", "kv_heads", None),
    "v": (None, "batch", "kv_seq", "kv_heads", None),
    "length": ("batch",),
    "offset": ("batch",),
    # ssm
    "conv": (None, "batch", None, "state"),
    "state": (None, "batch", None, None, None),
    # hybrid
    "ring_k": (None, "batch", "kv_seq", "kv_heads", None),
    "ring_v": (None, "batch", "kv_seq", "kv_heads", None),
    "ring_pos": (None, "batch", None),
    "lru": (None, "batch", "state"),
    # hybrid conv is (n_rec, B, 3, lw) = same "conv" key
    # whisper
    "self_k": (None, "batch", "kv_seq", "kv_heads", None),
    "self_v": (None, "batch", "kv_seq", "kv_heads", None),
    "cross_k": (None, "batch", "kv_seq", "heads", None),
    "cross_v": (None, "batch", "kv_seq", "heads", None),
}

_STORE_AXES = {
    "k": (None, "chunks", "chunk_seq", "kv_heads", None),
    "v": (None, "chunks", "chunk_seq", "kv_heads", None),
    "emb": (None, "chunks", "kv_heads", None),
    "chunk_positions": (None,),
    "k_scale": (None, "chunks", "chunk_seq", "kv_heads"),
    "v_scale": (None, "chunks", "chunk_seq", "kv_heads"),
}


def _abstract_params(cfg: ModelConfig, rules, mesh, device) -> nn.Module:
    """The family's parameter module (``empty_params``) over fake tensors,
    each parameter a ``DTensor`` at its rules' placements."""
    with fake_tensors():
        params = empty_params(cfg, device)
    at = sp.param_pspecs(params, rules, mesh)
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(params.named_parameters()):
        *path, leaf = name.split(".")
        owner = params.get_submodule(".".join(path))
        owner.register_parameter(leaf, nn.Parameter(
            distribute_tensor(p.detach(), mesh, at[name]),
            requires_grad=False))
    return params


def _token_batch(cfg: ModelConfig, B: int, S: int, rules, mesh, device,
                 train: bool) -> Dict[str, torch.Tensor]:
    """Tokens (and for training targets and mask) of B rows of S positions,
    the VLM's text after its patches, the frontend's embeddings."""
    with fake_tensors():
        St = S - cfg.encoder.frontend_seq if cfg.family == VLM else S
        out = {"tokens": torch.empty((B, St), dtype=torch.int64,
                                     device=device)}
        if train:
            out["targets"] = torch.empty((B, St), dtype=torch.int64,
                                         device=device)
            out["mask"] = torch.empty((B, St), dtype=torch.float32,
                                      device=device)
        if cfg.family in (VLM, AUDIO):
            out["frontend_embeds"] = torch.empty(
                (B, cfg.encoder.frontend_seq, cfg.encoder.frontend_dim),
                dtype=torch.bfloat16, device=device)
    return {k: place(t, ("batch",), rules, mesh) for k, t in out.items()}


def build_train(arch: str, cfg: ModelConfig, ishape: InputShape, mesh,
                variant: Optional[str] = None, device="cpu"
                ) -> LoweringSpec:
    zero1 = False
    if variant and "zero1" in variant:
        # ZeRO-1: weights TP-only (replicated over data), the optimizer
        # moments fully sharded over data
        zero1 = True
        variant = ",".join(k for k in variant.split(",") if k != "zero1") \
            or None
    rules = sp.apply_variant(sp.TRAIN_RULES, variant)
    model = build_model(cfg)
    if zero1:
        params = _abstract_params(
            cfg, sp.apply_variant(rules, "weights_resident"), mesh, device)
        moments = _abstract_params(cfg, rules, mesh, device)
        opt = adamw_init(moments)
        rules = sp.apply_variant(rules, "weights_resident")
    else:
        params = _abstract_params(cfg, rules, mesh, device)
        opt = adamw_init(params)
    batch = _token_batch(cfg, ishape.global_batch, ishape.seq_len, rules,
                         mesh, device, train=True)
    step = make_train_step(model, TrainLoopConfig(num_steps=1000,
                                                  remat=True))

    def fn(p, o, b):
        with trainable(p):
            return step(p, o, b)

    return LoweringSpec(arch, ishape.name, fn, (params, opt, batch), rules)


def build_prefill(arch: str, cfg: ModelConfig, ishape: InputShape, mesh,
                  variant: Optional[str] = None, device="cpu"
                  ) -> LoweringSpec:
    rules = sp.apply_variant(sp.SERVE_RULES, variant)
    model = build_model(cfg)
    params = _abstract_params(cfg, rules, mesh, device)
    B, S = ishape.global_batch, ishape.seq_len
    batch = _token_batch(cfg, B, S, rules, mesh, device, train=False)
    cache = place_fields(model.init_cache(B, S, device=device,
                                          abstract=True),
                         _CACHE_AXES, rules, mesh)
    args = [params, batch["tokens"], cache]
    note = ""
    if "frontend_embeds" in batch:
        args.append(batch["frontend_embeds"])
        note = "stub frontend embeddings"

    def fn(p, t, c, f=None):
        return model.prefill(p, t, c, frontend_embeds=f)

    return LoweringSpec(arch, ishape.name, fn, tuple(args), rules, note)


def build_decode(arch: str, cfg: ModelConfig, ishape: InputShape, mesh,
                 variant: Optional[str] = None, device="cpu"
                 ) -> LoweringSpec:
    long_ctx = ishape.name == "long_500k"
    dense = cfg.family in (DENSE, VLM, MOE)
    if long_ctx and cfg.family == AUDIO:
        raise Skip("enc-dec audio has no 500K-token decode analogue "
                   "(DESIGN.md §4)")
    rules = sp.apply_variant(
        sp.LONGCTX_RULES if long_ctx else sp.SERVE_RULES, variant)
    note = ""
    if long_ctx and dense:
        if not cfg.moska.enabled:
            raise Skip("full-attention arch without MoSKA routing is "
                       "quadratic at 500K")
        note = ("500K context = MoSKA shared chunk store, routed "
                "sub-quadratic attention (the paper's mechanism)")
    model = build_model(cfg)
    params = _abstract_params(cfg, rules, mesh, device)
    B = ishape.global_batch
    with fake_tensors():
        toks = torch.empty((B,), dtype=torch.int64, device=device)
    toks = place(toks, ("batch",), rules, mesh)
    if long_ctx:
        cache_len = LONG500K_UNIQUE_BUF if dense else ishape.seq_len
        shared_tokens = ishape.seq_len
    else:
        cache_len, shared_tokens = ishape.seq_len, DECODE32K_SHARED_TOKENS
    cache = place_fields(model.init_cache(B, cache_len, device=device,
                                          abstract=True),
                         _CACHE_AXES, rules, mesh)
    if not (cfg.moska.enabled and dense):
        return LoweringSpec(arch, ishape.name,
                            lambda p, t, c: model.decode_step(p, t, c),
                            (params, toks, cache), rules, note)
    store = place_fields(abstract_store(cfg, shared_tokens, device=device),
                         _STORE_AXES, rules, mesh)
    note = note or f"MoSKA store: {shared_tokens} shared tokens"
    return LoweringSpec(
        arch, ishape.name,
        lambda p, t, c, s: model.decode_step(p, t, c, store=s),
        (params, toks, cache, store), rules, note)


# config-level variants (beside the sharding-rule variants of
# ``sharding.specs.VARIANTS``)
CFG_VARIANTS = {
    "bigblock": dict(attn_block_k=4096),
    "smallblock": dict(attn_block_k=512),
    "remat_dots": dict(remat_policy="dots"),
    "no_remat": dict(remat_policy="none"),
}


def build(arch: str, shape_name: str, mesh, variant: Optional[str] = None,
          device="cpu", layers: Optional[int] = None) -> LoweringSpec:
    """The step of ``arch`` at ``shape_name`` on ``mesh`` (a ``DeviceMesh``
    over the process group), its arguments fake ``DTensor`` values on
    ``device``. ``variant``: comma-joined names of ``CFG_VARIANTS``,
    ``int8store`` (an int8 shared store), ``zero1`` (train) and rule
    variants (``sharding.specs.VARIANTS``). ``layers``: the stack cut to
    that depth (the dry run's extrapolation)."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rule_keys = []
    if variant:
        for key in variant.split(","):
            if key == "int8store":
                cfg = dataclasses.replace(cfg, moska=dataclasses.replace(
                    cfg.moska, kv_quant="int8"))
            elif key in CFG_VARIANTS:
                cfg = dataclasses.replace(cfg, **CFG_VARIANTS[key])
            else:
                rule_keys.append(key)
        variant = ",".join(rule_keys) or None
    ishape = INPUT_SHAPES[shape_name]
    build_step = {"train": build_train, "prefill": build_prefill}.get(
        ishape.kind, build_decode)
    return build_step(arch, cfg, ishape, mesh, variant=variant,
                      device=device)
