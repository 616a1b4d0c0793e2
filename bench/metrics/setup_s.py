"""Process start to window open, in s (host clock): imports, kernel load,
weights, corpus registration, filling the batch and the warm waves."""


def read(rec):
    return rec.setup_s
