"""Quantized compute ops and their kernels."""
