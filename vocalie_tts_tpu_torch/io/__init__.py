"""Audio file I/O (copy of the JAX package's numpy WAV codec)."""
