"""Block arithmetic shared by the scheduler's memory accounting."""
from __future__ import annotations


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks covering ``n_tokens`` tokens (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"negative token count {n_tokens}")
    return -(-n_tokens // block_size)
