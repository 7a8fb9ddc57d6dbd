"""Training: presets, optimizer, trainer and CLI."""
