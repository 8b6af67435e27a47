"""Measurement tools for the card."""
