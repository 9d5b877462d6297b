"""Data: training datasets and batching, and the data preparation (tokenize,
the CLIP feature encoders, merge-features)."""
