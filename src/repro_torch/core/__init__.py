"""MoSKA core: shared KV store, router, shared attention, scheduler, and
the disaggregated shared-KV pool."""
from repro_torch.core.disagg import (  # noqa: F401
    disaggregated_shared_attention, local_chunks, local_shard,
)
