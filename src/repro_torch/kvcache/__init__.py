"""Unique-KV caches of the port: the slotted slab and the paged pool."""
from repro_torch.kvcache.cache import (  # noqa: F401
    KVCache, append_token, init_kv_cache, read_slot, write_prefix,
    write_slot_prefix,
)
from repro_torch.kvcache.block_table import (  # noqa: F401
    NULL_BLOCK, SlotTables, blocks_for, validate_block_size,
)
from repro_torch.kvcache.paged import (  # noqa: F401
    BlockPool, PagedKVCache, PoolExhausted, append_layer, copy_block,
    gather_layer, grow_paged_kv_cache, init_paged_kv_cache, write_blocks,
)
