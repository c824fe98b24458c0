"""vocalie_tts_tpu_torch — the PyTorch/CUDA port of ``vocalie_tts_tpu``.

The JAX package beside it is the reference: module paths mirror its
paths, param trees keep its keys and layouts (see ``bridge``), and each
Pallas kernel on a ported path has a CUDA C++ counterpart under
``csrc/`` with a plain PyTorch version beside its wrapper in ``ops/``.

Importing the package touches no GPU and compiles nothing: kernels are
built with ``nvcc`` at their first launch (``ops/_build.py``). Entry
points take ``device`` (default ``"cuda"``) and raise when no GPU is
present instead of running on the CPU; tests pass ``device="cpu"``.
"""

__all__ = ["device"]
