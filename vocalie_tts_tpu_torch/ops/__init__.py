"""Ops of the port: the hand-written CUDA kernels' wrappers and their plain
PyTorch versions, plus the decode loop."""
