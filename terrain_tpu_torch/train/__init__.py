"""Training: checkpoints, losses, optimizers and the four-network step."""
