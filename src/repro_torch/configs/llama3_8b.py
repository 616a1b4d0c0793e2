"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783].

This is the paper's own evaluation model family (Llama 3.1 8B); it is the
primary MoSKA hillclimb target.
"""
from repro_torch.configs.base import ModelConfig, MoSKAConfig, DENSE

CONFIG = ModelConfig(
    name="llama3-8b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
    moska=MoSKAConfig(enabled=True, chunk_size=2048, top_k_chunks=8,
                      sparsity=0.75),
)
