"""Mean admission prefill in the window, in ms: the engine's
``engine/prefill_latency_s`` histogram's sum over its count, both taken
as gained in the window (host clock around a prefill that ends in the
first token's readback)."""


def read(rec):
    v = rec.hist_mean("engine/prefill_latency_s")
    return None if v is None else v * 1e3
