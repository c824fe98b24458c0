"""Chatterbox-class model and runtime."""
