"""95th percentile over every gap between consecutive tokens of one request
whose later token landed in the window, in ms (host clock)."""
from moska_bench import stats


def read(rec):
    v = stats.p95(stats.itl_samples(rec.window, rec.logs))
    return None if v is None else v * 1e3
