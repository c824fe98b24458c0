"""Model graphs of the port."""
