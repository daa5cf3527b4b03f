"""Training: the encoder-stage train step and what it needs."""
