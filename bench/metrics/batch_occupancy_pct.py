"""Mean share of the batch's slots active in the window's decode waves, in
%: the engine's ``engine/wave_active_slots`` histogram's sum over its
count, gained in the window, over ``max_slots``."""


def read(rec):
    v = rec.hist_mean("engine/wave_active_slots")
    return None if v is None else 100.0 * v / rec.max_slots
