"""Entry points of the port: infer and serve."""
