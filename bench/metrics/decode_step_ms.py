"""Mean decode step in the window, in ms: the engine's ``decode_step_s``
samples (host clock from the step's launch to its tokens' readback)."""


def read(rec):
    s = rec.decode_step_s
    return 1e3 * sum(s) / len(s) if s else None
