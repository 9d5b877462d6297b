"""Training: the train state, the train step and trainer, and the flow-prior
trainer, on one device or over a parallel/mesh.py mesh."""
