"""The plain float32 reference: models, sampler arithmetic, weights."""
