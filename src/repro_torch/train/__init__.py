"""Training: optimizer, train step, checkpoints and the resilient loop."""
