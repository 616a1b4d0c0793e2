"""``ops.decode_attention``: a call's work from the frozen ``work.py`` at no
cached token attended, plus the work of one; the count is the cached
tokens attended, each request's ``kv_len`` within the cache (and within
the window, if there is one)."""
from moska_bench import work as frozen

OP = "decode_attention"


def work(q, k, v, kv_len, window=0):
    f = frozen.decode_attention
    f0 = f(q, k, v, kv_len, window, tokens=0)
    f1 = f(q, k, v, kv_len, window, tokens=1)
    return f0, (tuple(a - b for a, b in zip(f1, f0)),)


def counts(q, k, v, kv_len, window=0):
    lim = k.shape[1] if not window else min(window, k.shape[1])
    return kv_len.long().clamp(max=lim).sum()[None]
