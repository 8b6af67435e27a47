"""Test-sweep scoring."""
