"""VITS-class non-autoregressive TTS (the Piper fr_FR engine)."""
