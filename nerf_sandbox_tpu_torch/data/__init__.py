"""Training data: scene records and the ray-batch sampler."""
