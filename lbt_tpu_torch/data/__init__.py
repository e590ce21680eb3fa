"""Datasets, augmentation and the host input pipeline."""
