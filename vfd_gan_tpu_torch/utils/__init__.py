"""Weight init, the weight bridge, checkpoints and device selection."""
