"""moska-llama3.1-8b — the paper's own evaluation configuration (§IV).

Llama 3.1 8B backbone with the full MoSKA feature set at the paper's
operating point: 75% sparsity, 2048-token shared chunks, 64K unique
context + 1M..16M shared corpus.
"""
import dataclasses

from repro_torch.configs.base import MoSKAConfig
from repro_torch.configs.llama3_8b import CONFIG as _LLAMA3

CONFIG = dataclasses.replace(
    _LLAMA3,
    name="moska-llama3.1-8b",
    moska=MoSKAConfig(
        enabled=True,
        chunk_size=2048,
        top_k_chunks=8,
        sparsity=0.75,
        query_capacity_factor=2.0,
        max_shared_tokens=16 * 1024 * 1024,
    ),
)
