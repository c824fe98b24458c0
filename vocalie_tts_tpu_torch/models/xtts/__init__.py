"""XTTS-class model and runtime."""
