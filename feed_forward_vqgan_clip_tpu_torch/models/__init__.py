"""Model modules of the served path: CLIP text tower, Mixer mapper, VQGAN decoder."""
