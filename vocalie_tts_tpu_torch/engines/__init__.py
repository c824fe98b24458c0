"""Engines of the port, by backend id. ``ENGINES`` is the port's own map:
the JAX package registers its engines by id on import, and a port engine
sharing that registry would replace the JAX one."""

from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine
from vocalie_tts_tpu_torch.engines.cosyvoice import CosyVoiceEngine
from vocalie_tts_tpu_torch.engines.piper import PiperEngine
from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
from vocalie_tts_tpu_torch.engines.xtts import XTTSEngine

ENGINES = {"chatterbox": ChatterboxEngine, "cosyvoice": CosyVoiceEngine, "xtts": XTTSEngine,
           "qwen3": Qwen3Engine, "piper": PiperEngine}

__all__ = ["ENGINES", "ChatterboxEngine", "CosyVoiceEngine", "PiperEngine", "Qwen3Engine",
           "XTTSEngine"]
