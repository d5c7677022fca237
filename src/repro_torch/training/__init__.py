"""Training-side helpers the serving path reuses (int8 quantization)."""
