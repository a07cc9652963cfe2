"""Weight conversion and checkpoints of the port."""
