"""``torch.cuda.max_memory_allocated()`` over the whole run up to the close
of the window (set-up included), in GiB."""


def read(rec):
    return rec.peak_bytes / 2 ** 30
