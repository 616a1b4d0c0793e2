"""Unique-KV cache of the port (slotted layout)."""
from repro_torch.kvcache.cache import (  # noqa: F401
    KVCache, append_token, init_kv_cache, read_slot, write_prefix,
    write_slot_prefix,
)
