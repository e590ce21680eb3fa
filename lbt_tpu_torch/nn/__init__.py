"""Quantized layer library (nn.Module based)."""
