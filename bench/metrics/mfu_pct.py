"""Model FLOPs of every prefill and decode step whose token landed in the
window (counted by the benchmark from the configuration and the steps'
shapes, by the architecture's ``bench/archs/<arch>/layout.py``) over the
window's length times the card's bf16 peak, in %."""
from moska_bench import peaks


def read(rec):
    return 100.0 * rec.model_flops / (rec.window.seconds * peaks.BF16_FLOPS)
