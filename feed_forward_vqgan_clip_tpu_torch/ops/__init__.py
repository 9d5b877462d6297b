"""Straight-through ops, vector quantization and the CUDA kernels (ops/kernels)."""
