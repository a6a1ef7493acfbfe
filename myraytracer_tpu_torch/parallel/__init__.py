"""Scene-parameter plumbing of the training step (torch)."""
