"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent
[arXiv:2402.19427].

MoSKA applies in part: attention layers use per-request
sliding windows; MoSKA routed shared attention is exposed as an optional
extra path (default off, Griffin-faithful).
"""
from repro_torch.configs.base import ModelConfig, HybridConfig, MoSKAConfig, HYBRID

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family=HYBRID,
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,      # MQA
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10000.0,
    source="arXiv:2402.19427",
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"), window=2048),
    moska=MoSKAConfig(enabled=False),
)
