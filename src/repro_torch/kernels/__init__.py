"""Hand-written Hopper kernels (csrc/), their wrappers (ops) and plain versions (ref)."""
