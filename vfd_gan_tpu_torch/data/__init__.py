"""Batch sources."""
