"""The engine's ``engine.register_corpus`` span (corpus prefill and store
build, ending in a device synchronize), summed, in s."""


def read(rec):
    return rec.corpus_register_s
