"""Training: the optimiser and the Trainer."""
