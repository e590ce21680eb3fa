"""Training: the momentum-SGD optimizer and the single-device step."""
