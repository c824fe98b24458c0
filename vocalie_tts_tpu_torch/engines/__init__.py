"""Engines of the port. No registry: callers construct the engine they
want (the JAX package registers engines by id on import, and a port
subclass sharing that registry would replace the JAX engine)."""
