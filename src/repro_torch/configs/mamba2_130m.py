"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060].

MoSKA does not apply: there is no KV cache. The analogue is a shared
warm-start SSM state for shared prefixes
(``repro_torch.models.ssm.shared_state``).
"""
from repro_torch.configs.base import ModelConfig, MoSKAConfig, SSMConfig, SSM

CONFIG = ModelConfig(
    name="mamba2-130m",
    family=SSM,
    num_layers=24,
    d_model=768,
    num_heads=0,        # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    source="arXiv:2405.21060",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    moska=MoSKAConfig(enabled=False),
)
