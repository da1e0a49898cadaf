"""Losses, metrics, optimizer and the training loop."""
