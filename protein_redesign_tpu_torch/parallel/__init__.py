"""Training steps for the port (one device)."""
