"""Unique-KV caches of the port: the slotted slab, the paged pool, the
host tier behind it, and the prefetch engine that brings pages back."""
from repro_torch.kvcache.cache import (  # noqa: F401
    KVCache, append_token, init_kv_cache, read_slot, write_prefix,
    write_slot_prefix,
)
from repro_torch.kvcache.block_table import (  # noqa: F401
    NULL_BLOCK, SlotTables, blocks_for, validate_block_size,
)
from repro_torch.kvcache.paged import (  # noqa: F401
    BlockPool, HostBlockPool, PagedKVCache, PoolExhausted, append_index,
    append_layer, copy_block, extract_blocks, gather_layer,
    grow_paged_kv_cache, init_paged_kv_cache, insert_blocks, write_blocks,
)
from repro_torch.kvcache.transfer import PrefetchEngine  # noqa: F401
