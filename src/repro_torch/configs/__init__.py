"""The port's own copies of the reference's model configurations."""
