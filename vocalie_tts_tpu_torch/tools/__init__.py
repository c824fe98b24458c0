"""Measurement tools of the port that need an NVIDIA GPU, each run as a
module from the repository's root:

- ``python3 -m vocalie_tts_tpu_torch.tools.tail_swiglu_trace``: where a
  call of the one-launch SwiGLU layer tail (B2, B8a) spends its time, phase
  by phase, from the card's clock. Rerun it after a change to
  ``csrc/tail_swiglu.cu``.
- ``python3 -m vocalie_tts_tpu_torch.tools.weight_stream_probe``: how fast
  one persistent block per SM streams an int8 weight matrix into shared
  memory, by slab width, and what a grid barrier costs: the measurements
  behind that kernel's tile shape.

``chip_smoke.py`` remains the check of every kernel and path; these tools
only explain a kernel's time.
"""
