"""Training: optimizer, train/eval steps, checkpoints and the Trainer."""
