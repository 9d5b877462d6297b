"""Training data: datasets and per-epoch batching."""
