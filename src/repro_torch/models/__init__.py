"""Model substrate: the dense transformer (serving) and the EmbeddingBag
substrate of the recsys models."""
