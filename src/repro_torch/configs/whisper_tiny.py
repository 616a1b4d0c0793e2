"""whisper-tiny — encoder-decoder audio model, conv frontend stubbed
[arXiv:2212.04356].

The mel-spectrogram + conv1d feature extractor is a stub: the caller hands
``Model.prefill(frontend_embeds=)`` precomputed frame embeddings (batch,
1500, 384).
MoSKA partial applicability: cross-attention KV (shared encoder output) is
the shared cache when many requests decode against the same audio corpus.
"""
from repro_torch.configs.base import ModelConfig, EncoderConfig, MoSKAConfig, AUDIO

CONFIG = ModelConfig(
    name="whisper-tiny",
    family=AUDIO,
    num_layers=4,        # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    source="arXiv:2212.04356",
    encoder=EncoderConfig(num_layers=4, frontend_seq=1500, frontend_dim=384),
    moska=MoSKAConfig(enabled=True, chunk_size=375, top_k_chunks=2),
)
