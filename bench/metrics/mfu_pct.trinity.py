"""Trinity-Mini's share of the whole step's bf16 peak, in %: the model
FLOPs of every prefill and decode step whose token landed in the window
(``bench/archs/afmoe/layout.py``: a sliding layer's query over min(position
+ 1, window) keys, a full layer's over its own and its routed chunks'
keys, the top-8 experts' and the shared expert's work, the dense layers,
the logits) over the window's length times the card's bf16 peak; read as
``mfu_pct`` is."""
from moska_bench import peaks


def read(rec):
    return 100.0 * rec.model_flops / (rec.window.seconds * peaks.BF16_FLOPS)
