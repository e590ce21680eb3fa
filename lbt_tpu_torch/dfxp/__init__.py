"""DFXP quantization primitives."""
