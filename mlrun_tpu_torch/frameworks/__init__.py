"""Framework adapters of the port (the torch auto-trainer so far)."""
