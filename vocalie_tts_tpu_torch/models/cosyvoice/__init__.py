"""CosyVoice-class model and runtime."""
