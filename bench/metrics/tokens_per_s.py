"""Output tokens that landed in the window over its length (host clock)."""
from moska_bench import stats


def read(rec):
    return stats.tokens_per_s(rec.window, rec.logs)
