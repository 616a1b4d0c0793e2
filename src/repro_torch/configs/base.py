"""Config system for the MoSKA reproduction framework.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
Configs are plain frozen dataclasses so they hash, compare, and serialize
cleanly; ``reduced()`` produces the CPU-smoke variant mandated by the
assignment (<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (dropping / capacity-based)."""

    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # Arctic keeps a dense FFN residual path in parallel with the experts.
    dense_residual: bool = False
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # the afmoe router's settings (fields of ``AfmoeMoEConfig``); here the
    # values every other MoE has, as class constants, so that this class's
    # fields stay the reference's
    score_func = "softmax"
    route_norm = True
    route_scale = 1.0
    shared_expert_width = 0

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class AfmoeMoEConfig(MoEConfig):
    """The afmoe MoE: a softmax or a sigmoid router, the latter choosing
    the top_k by score plus a per-expert selection bias (the layer's
    ``expert_bias`` leaf) and weighting them by the unbiased scores; the
    chosen weights divided by their sum under ``route_norm`` (the softmax
    path always renormalises), times ``route_scale``; and a SwiGLU shared
    expert of ``shared_expert_width`` that every token takes beside its
    top_k (0: none)."""

    score_func: str = "softmax"
    route_norm: bool = True
    route_scale: float = 1.0
    shared_expert_width: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD, state-space duality) block configuration."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256  # SSD block size for the chunked-scan algorithm

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma / Griffin-style hybrid configuration.

    ``pattern`` is a tuple over the layer cycle, e.g. ("rglru", "rglru",
    "attn") is the Griffin 1-attention-per-3 pattern. Attention layers use a
    local sliding window.
    """

    pattern: Tuple[str, ...] = ()
    window: int = 2048
    lru_width: Optional[int] = None  # defaults to d_model

    @property
    def enabled(self) -> bool:
        return len(self.pattern) > 0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec (audio) and VLM architectures.

    The modality frontend (mel+conv for audio, ViT for vision) is a STUB per
    the assignment: ``input_specs`` hands the backbone precomputed frame /
    patch embeddings of shape (batch, frontend_seq, frontend_dim).
    """

    num_layers: int = 0
    frontend_seq: int = 0  # frames (audio) or patches (vision)
    frontend_dim: int = 0  # embedding dim delivered by the stub frontend
    is_causal: bool = False

    @property
    def enabled(self) -> bool:
        return self.num_layers > 0 or self.frontend_seq > 0


@dataclass(frozen=True)
class MoSKAConfig:
    """The paper's technique: shared-KV chunk store + routed GEMM attention."""

    enabled: bool = True
    chunk_size: int = 2048          # tokens per shared chunk ("expert")
    top_k_chunks: int = 8           # chunks selected per query group
    # paper evaluates 75% sparsity => top_k/num_chunks ~ 0.25 at eval time
    sparsity: float = 0.75
    query_capacity_factor: float = 2.0  # per-chunk query batching capacity
    router: str = "mean_key"        # chunk embedding = mean of chunk keys
    # Apply MoSKA to shared context at decode; unique KV stays GEMV path.
    max_shared_tokens: int = 16 * 1024 * 1024
    kv_quant: str = "none"          # none | int8 (capacity parity w/ FP8)

    @property
    def keep_fraction(self) -> float:
        return 1.0 - self.sparsity


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=lambda: SSMConfig(state_dim=0))
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    moska: MoSKAConfig = field(default_factory=MoSKAConfig)
    # provenance: paper / model card the config was taken from
    source: str = ""
    # sliding-window for dense archs that opt into sub-quadratic attention
    attn_window: int = 0            # 0 => full causal attention
    # §Perf knobs: flash-attention KV block (train/prefill) + remat policy
    attn_block_k: int = 1024
    remat_policy: str = "nothing"   # nothing | dots | none
    # the afmoe layers' settings (fields of ``AfmoeConfig``); here the
    # values every other config has, as class constants, so that this
    # class's fields stay the reference's
    layer_windows = ()
    nope_full_layers = False
    qk_norm = False
    attn_gate = False
    sandwich_norm = False
    num_dense_layers = 0
    dense_d_ff = 0
    embed_scale = 1.0

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.num_heads and self.num_kv_heads:
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"{self.name}: num_heads {self.num_heads} not divisible by "
                    f"kv heads {self.num_kv_heads}")
        if self.layer_windows and len(self.layer_windows) != self.num_layers:
            raise ValueError(
                f"{self.name}: {len(self.layer_windows)} layer windows for "
                f"{self.num_layers} layers")
        if self.moe.score_func not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: score_func "
                             f"{self.moe.score_func!r}: softmax | sigmoid")

    # ------------------------------------------------------------------
    def window(self, i: int) -> int:
        """Layer i's sliding window (0: full causal attention)."""
        return self.layer_windows[i] if self.layer_windows else self.attn_window

    def rope_at(self, i: int) -> bool:
        """Whether layer i rotates its queries and keys."""
        return not (self.nope_full_layers and self.window(i) == 0)

    def moe_at(self, i: int) -> bool:
        """Whether layer i's FFN is the MoE (the leading dense layers' is
        not)."""
        return self.moe.enabled and i >= self.num_dense_layers

    def ffn_width(self, i: int) -> int:
        """Layer i's dense SwiGLU width."""
        if i < self.num_dense_layers and self.dense_d_ff:
            return self.dense_d_ff
        return self.d_ff

    @property
    def afmoe_features(self) -> Tuple[str, ...]:
        """The afmoe features this config turns on, by field name: the
        paths that do not take them (training, meshes) name them when they
        refuse."""
        on = [n for n in ("layer_windows", "nope_full_layers", "qk_norm",
                          "attn_gate", "sandwich_norm", "num_dense_layers")
              if getattr(self, n)]
        if self.embed_scale != 1.0:
            on.append("embed_scale")
        if self.moe.score_func != "softmax":
            on.append("moe.score_func")
        if self.moe.shared_expert_width:
            on.append("moe.shared_expert_width")
        return tuple(on)

    # ------------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec included)

    @property
    def kv_bytes_per_token(self) -> int:
        """KV cache bytes per token (bf16 unless int8-quantized)."""
        if self.attention_free:
            return 0
        itemsize = 1 if self.moska.kv_quant == "int8" else 2
        n_attn_layers = self.num_attention_layers
        return 2 * n_attn_layers * self.num_kv_heads * self.head_dim * itemsize

    @property
    def num_attention_layers(self) -> int:
        if self.family == SSM:
            return 0
        if self.hybrid.enabled:
            cyc = self.hybrid.pattern
            full, rem = divmod(self.num_layers, len(cyc))
            return full * sum(1 for p in cyc if p == "attn") + sum(
                1 for p in cyc[:rem] if p == "attn")
        return self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + stacked blocks)."""
        d, f, L, V = self.d_model, self.d_ff, self.num_layers, self.vocab_size
        hd, H, KH = self.head_dim, self.num_heads, self.num_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family == SSM:
            di = d * self.ssm.expand
            nheads = di // self.ssm.head_dim
            per = (d * (2 * di + 2 * self.ssm.state_dim * (di // self.ssm.head_dim) // max(1, di // self.ssm.head_dim)) )
            # in_proj: d -> (2*di + 2*ngroups*state + nheads); out_proj di->d
            per = d * (2 * di + 2 * self.ssm.state_dim + nheads) + di * d
            per += di * self.ssm.conv_width + nheads * 2 + 2 * d  # conv, A/D, norms
            total += L * per
            return total
        attn = d * (H * hd) + 2 * d * (KH * hd) + (H * hd) * d
        if self.afmoe_features:
            return total + sum(self._afmoe_layer_params(i) for i in range(L))
        ffn_dense = 3 * d * f  # gate, up, down (SwiGLU)
        per_layer = attn + 2 * d  # + norms
        if self.moe.enabled:
            expert = 3 * d * f
            per_layer += self.moe.num_experts * expert + d * self.moe.num_experts
            if self.moe.dense_residual:
                per_layer += ffn_dense
        elif self.hybrid.enabled:
            pass  # handled below per pattern
        else:
            per_layer += ffn_dense
        if self.hybrid.enabled:
            lw = self.hybrid.lru_width or d
            rglru = d * (2 * lw) + lw * d + 3 * lw  # in/out proj + gates
            cyc = self.hybrid.pattern
            n_attn = self.num_attention_layers
            n_rec = L - n_attn
            total += n_attn * (attn + ffn_dense + 2 * d)
            total += n_rec * (rglru + ffn_dense + 2 * d)
        else:
            total += L * per_layer
        if self.encoder.num_layers > 0:  # enc-dec only (VLM embeds inline)
            e_attn = 4 * d * d
            e_ffn = 2 * d * f  # whisper uses GELU MLP (2 mats)
            total += self.encoder.num_layers * (e_attn + e_ffn + 2 * d)
            total += self.num_layers * e_attn  # decoder cross-attention
        return total

    def _afmoe_layer_params(self, i: int) -> int:
        """Layer i of an afmoe config: attention (with its gate and q/k
        norms), its norms, and a dense SwiGLU or the MoE (router, its bias,
        experts, shared expert)."""
        d, hd = self.d_model, self.head_dim
        hq, hkv = self.num_heads * hd, self.num_kv_heads * hd
        n = 2 * d * hq + 2 * d * hkv + 2 * d
        n += d * hq if self.attn_gate else 0
        n += 2 * hd if self.qk_norm else 0
        n += 2 * d if self.sandwich_norm else 0
        if not self.moe_at(i):
            return n + 3 * d * self.ffn_width(i)
        E = self.moe.num_experts
        n += E * 3 * d * self.d_ff + d * E
        n += E if self.moe.score_func == "sigmoid" else 0
        n += 3 * d * self.moe.shared_expert_width
        return n + (3 * d * self.d_ff if self.moe.dense_residual else 0)

    def active_param_count(self) -> int:
        """Active params per token (MoE activates top_k of num_experts)."""
        if not self.moe.enabled:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        expert = 3 * d * f
        moe_layers = sum(self.moe_at(i) for i in range(L))
        inactive = (self.moe.num_experts - self.moe.top_k) * expert * moe_layers
        return self.param_count() - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        layers = min(self.num_layers, 2)
        if self.hybrid.enabled:
            layers = min(self.num_layers, len(self.hybrid.pattern))
        kw: Dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            moska=dataclasses.replace(
                self.moska, chunk_size=64, top_k_chunks=2,
                max_shared_tokens=4096),
        )
        if self.moe.enabled:
            moe = dict(num_experts=min(self.moe.num_experts, 4),
                       top_k=min(self.moe.top_k, 2))
            if self.moe.shared_expert_width:
                moe["shared_expert_width"] = min(
                    self.moe.shared_expert_width, 512)
            kw["moe"] = dataclasses.replace(self.moe, **moe)
        if self.layer_windows:
            kw["layer_windows"] = tuple(min(w, 64)
                                        for w in self.layer_windows[:layers])
        if self.num_dense_layers:
            kw["num_dense_layers"] = min(self.num_dense_layers, layers - 1)
            kw["dense_d_ff"] = min(self.dense_d_ff, 512)
        if self.ssm.enabled:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=32, head_dim=32, chunk_size=32)
        if self.hybrid.enabled:
            kw["hybrid"] = dataclasses.replace(self.hybrid, window=64)
        if self.encoder.enabled:
            kw["encoder"] = dataclasses.replace(
                self.encoder, num_layers=min(self.encoder.num_layers, 2),
                frontend_seq=min(self.encoder.frontend_seq or 64, 64),
                frontend_dim=d)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AfmoeConfig(ModelConfig):
    """A model of afmoe layers (arcee-ai's Trinity): per-layer sliding
    windows, NoPE on the full layers, q and k norms, an output gate,
    sandwich norms, dense leading layers and an embedding scale. Its MoE
    is an ``AfmoeMoEConfig``."""

    # per layer, 0 => full causal attention; () => every layer attn_window
    layer_windows: Tuple[int, ...] = ()
    nope_full_layers: bool = False  # no RoPE on full-attention layers
    qk_norm: bool = False           # RMSNorm over head_dim of each q and k head
    attn_gate: bool = False         # o * sigmoid(h Wg) before the output proj
    sandwich_norm: bool = False     # RMSNorm of the attention's and FFN's outputs
    num_dense_layers: int = 0       # leading layers with a dense SwiGLU (MoE after)
    dense_d_ff: int = 0             # their width (0 => d_ff)
    embed_scale: float = 1.0        # token embeddings times this (muP: sqrt(d))


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES: Dict[str, InputShape] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}
