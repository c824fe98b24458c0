"""Host-side audio DSP (copy of the JAX package's numpy/scipy ``dsp/host.py``)."""
