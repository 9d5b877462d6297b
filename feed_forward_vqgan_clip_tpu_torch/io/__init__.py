"""Weight conversion from the JAX package and image writing."""
