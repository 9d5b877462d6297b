"""Hand-written Hopper kernels (csrc/*.cu), their wrappers and plain versions."""
