"""Measurement tools of the port that need an NVIDIA GPU, each run as a
module from the repository's root:

- ``python3 -m vocalie_tts_tpu_torch.tools.tail_swiglu_trace``: where a
  call of the one-launch layer tails (B2, B8a; B9b, and the old 12-kernel
  chain B9c still runs, kernel by kernel) spends its time, phase by phase,
  from the card's clock. Rerun it after a change to ``csrc/tail_swiglu.cu``
  or ``csrc/tail_gelu.cu``.
- ``python3 -m vocalie_tts_tpu_torch.tools.decode_step_trace``: the same
  for one layer of the whole-step kernel (B7, ``csrc/decode_step.cu``),
  with when each block's ring requested its tiles and when it waited for
  them.
- ``python3 -m vocalie_tts_tpu_torch.tools.weight_stream_probe``: how fast
  one persistent block per SM streams an int8 weight matrix into shared
  memory, by slab width, and what a grid barrier costs: the measurements
  behind that kernel's tile shape.
- ``python3 -m vocalie_tts_tpu_torch.tools.wrapper_host_ab PARENT_DIR``:
  the Python the B9b and B7 wrappers run before their C call, this tree's
  beside a parent commit's unpacked in ``PARENT_DIR``, in one process.
- ``python3 -m vocalie_tts_tpu_torch.tools.attn_gn_trace``: where a call of
  the int8 decode attention (B1, ``csrc/decode_attention.cu``, at every
  split count) and of the one-pass GroupNorm (B13, ``csrc/groupnorm.cu``,
  at the studio shapes) spends its time, phase by phase, from the card's
  clock.

``chip_smoke.py`` remains the check of every kernel and path; these tools
only explain a kernel's time.
"""
