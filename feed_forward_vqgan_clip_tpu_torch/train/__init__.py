"""Training: the train state and the single-device train step."""
