"""trinity-mini — afmoe: 3:1 sliding-window and full (NoPE) attention,
gated GQA with q/k norms and sandwich norms, two dense layers, then 128
sigmoid-routed experts top-8 plus a shared expert
[hf:arcee-ai/Trinity-Mini, config.json, model_type "afmoe"].

Not one of the reference package's configurations: ``get_config`` reaches
it by name, ``list_archs`` lists the reference's alone."""
import math

from repro_torch.configs.base import AfmoeConfig, AfmoeMoEConfig, MOE

_LAYERS = 32
_WINDOW = 2048          # sliding_window; layer_types: 3 sliding to 1 full

CONFIG = AfmoeConfig(
    name="trinity-mini",
    family=MOE,
    num_layers=_LAYERS,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1024,          # moe_intermediate_size: per-expert FFN width
    vocab_size=200192,
    rope_theta=10000.0,
    rms_eps=1e-5,
    tie_embeddings=False,
    source="hf:arcee-ai/Trinity-Mini",
    layer_windows=tuple(0 if i % 4 == 3 else _WINDOW for i in range(_LAYERS)),
    nope_full_layers=True,
    qk_norm=True,
    attn_gate=True,
    sandwich_norm=True,
    num_dense_layers=2,
    dense_d_ff=6144,    # intermediate_size of layers 0-1
    embed_scale=math.sqrt(2048),   # mup_enabled
    moe=AfmoeMoEConfig(num_experts=128, top_k=8, capacity_factor=1.25,
                  score_func="sigmoid", route_norm=True, route_scale=2.826,
                  shared_expert_width=1024),
)
