"""Tensor ops of the port (channel-last public signatures)."""
