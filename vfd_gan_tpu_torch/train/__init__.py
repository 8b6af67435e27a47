"""The training engine, its state and checkpoints."""
