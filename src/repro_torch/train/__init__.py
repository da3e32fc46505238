"""Training entry points of the port (the neural receivers)."""
