"""internvl2-76b — VLM: InternViT (stub) + InternLM2-76B LM [arXiv:2404.16821].

The vision frontend (InternViT-6B + MLP projector) is a stub: the caller
hands ``prefill(frontend_embeds=)`` precomputed patch embeddings of shape
(batch, num_patches, d_model); this config describes the language backbone.
"""
from repro_torch.configs.base import ModelConfig, EncoderConfig, VLM

CONFIG = ModelConfig(
    name="internvl2-76b",
    family=VLM,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
    encoder=EncoderConfig(num_layers=0, frontend_seq=256, frontend_dim=8192),
)
