"""Checkpoints (the reference's `.th`, the JAX package's msgpack directories),
weight conversion from the JAX package, CLIP layouts, and image writing."""
