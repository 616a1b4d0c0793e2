"""Logical-axis sharding rules over a ``torch.distributed`` device mesh."""
from repro_torch.sharding.specs import (  # noqa: F401
    LogicalRules, LONGCTX_RULES, SERVE_RULES, TRAIN_RULES, VARIANTS,
    apply_variant, current_rules, logical_sharding_constraint, lsc,
    named_sharding_tree, param_pspecs, param_specs, placements, set_rules,
    use_rules,
)
