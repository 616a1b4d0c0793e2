"""arctic-480b — 128-expert top-2 MoE with dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MOE

CONFIG = ModelConfig(
    name="arctic-480b",
    family=MOE,
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,          # per-expert FFN width
    vocab_size=32000,
    rope_theta=10000.0,
    source="hf:Snowflake/snowflake-arctic-base",
    moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual=True),
)
