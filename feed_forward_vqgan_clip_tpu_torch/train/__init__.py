"""Training: the train state, the single-device train step and trainer, and the
flow-prior trainer."""
