"""Qwen3-TTS-class model and runtime."""
