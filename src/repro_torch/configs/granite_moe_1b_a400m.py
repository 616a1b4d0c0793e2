"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MOE

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family=MOE,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,           # per-expert FFN width
    vocab_size=49155,
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    moe=MoEConfig(num_experts=32, top_k=8, capacity_factor=1.25),
)
