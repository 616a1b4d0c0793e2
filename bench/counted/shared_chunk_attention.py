"""``ops.shared_chunk_attention``: a call's work from the frozen ``work.py``
at no dispatched (chunk, slot) pair and no active chunk, plus the work of
one pair and of one chunk with a query; the counts are the call's
dispatched pairs (``qmask``'s set entries) and its chunks with a query."""
import torch

from moska_bench import work as frozen

OP = "shared_chunk_attention"


def _less(a, b):
    return tuple(x - y for x, y in zip(a, b))


def work(qd, k, v, qmask):
    f = frozen.shared_chunk_attention
    f0 = f(qd, k, v, qmask, valid=0, active=0)
    fv = f(qd, k, v, qmask, valid=1, active=0)
    fa = f(qd, k, v, qmask, valid=0, active=1)
    return f0, (_less(fv, f0), _less(fa, f0))


def counts(qd, k, v, qmask):
    return torch.stack([qmask.sum(), qmask.any(dim=1).sum()])
