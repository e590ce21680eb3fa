"""Logging, metrics and profiling."""
