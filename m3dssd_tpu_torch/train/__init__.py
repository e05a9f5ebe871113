"""Training: learning-rate policy, optimizer, train step and the trainer."""
