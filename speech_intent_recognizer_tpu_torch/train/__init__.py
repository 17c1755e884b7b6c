"""Training from precomputed features: optimizer, loop, checkpoints."""
