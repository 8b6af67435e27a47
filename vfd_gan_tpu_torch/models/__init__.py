"""Models of the port (NCDHW input, reference state_dict keys)."""
