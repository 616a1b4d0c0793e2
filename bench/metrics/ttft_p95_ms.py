"""95th percentile over every request whose first token landed in the
window of first-token time minus submit time, in ms (host clock)."""
from moska_bench import stats


def read(rec):
    v = stats.p95(stats.ttft_samples(rec.window, rec.logs))
    return None if v is None else v * 1e3
