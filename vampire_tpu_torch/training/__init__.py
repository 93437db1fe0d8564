"""Training: losses, metrics, optimizer state, train step, trainer."""
