"""MoSKA core: shared KV store, router, shared attention, scheduler."""
