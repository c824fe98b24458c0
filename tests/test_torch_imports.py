"""The port stands alone: no module of ``vocalie_tts_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; the package imports
with JAX blocked and without Triton or a GPU; and its entry points,
called without ``device="cpu"`` on a machine without CUDA, raise instead
of running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "vocalie_tts_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "vocalie_tts_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['triton'] = None\n"
        "sys.modules['vocalie_tts_tpu'] = None\n"
        "import importlib, pkgutil, vocalie_tts_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vocalie_tts_tpu_torch.engines.chatterbox import ChatterboxEngine
    from vocalie_tts_tpu_torch.models.chatterbox.runtime import ChatterboxRuntime
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_KV_INT8", "1")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChatterboxRuntime.create(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChatterboxEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tts_pipeline({"tts_backend": "chatterbox", "script": "Bonjour à tous.",
                          "out_path": str(tmp_path / "x.wav")})
    assert not (tmp_path / "x.wav").exists()


def test_dense_kernel_env_names_the_next_slice(monkeypatch):
    """``VOCALIE_DENSE_KERNEL=1`` forces the dense kernels, as in the JAX
    package (they are ported); ``VOCALIE_MEGATAIL=0`` takes the SwiGLU tail
    B8a (ported with the Qwen3 slice; GPT-2 takes B9c there, see
    ``tests/test_torch_xtts.py``); ``VOCALIE_MEGALAYER=1`` takes the whole
    layer B12 (ported with slice 7; ``tests/test_torch_dense_step.py`` holds
    it against JAX; it reads the int8 cache, so a bf16 cache takes the
    megatail). A GELU MLP with bias and RMSNorm, once refused, takes the
    ``DENSE_FNS`` path with B9d (``tests/test_torch_mlp_gelu.py`` holds it
    against JAX)."""
    import dataclasses

    from vocalie_tts_tpu_torch.models.chatterbox.runtime import SCALES
    from vocalie_tts_tpu_torch.models.common import transformer as tr
    from vocalie_tts_tpu_torch.models.common.ar_runtime import apply_runtime_env

    monkeypatch.setenv("VOCALIE_DENSE_KERNEL", "1")
    monkeypatch.setenv("VOCALIE_KV_INT8", "1")
    cfg = apply_runtime_env(SCALES["tiny"]).lm
    assert cfg.dense_kernel is True and cfg.kv_quant and cfg.decode_kernel
    cfg = dataclasses.replace(cfg, d_model=128, n_heads=2, n_kv_heads=2, d_head=64, d_ff=256)
    layers = {name: {"q": torch.zeros(shape, dtype=torch.int8)} for name, shape in (
        ("wqkv", (2, 128, 384)), ("wo", (2, 128, 128)),
        ("w_gateup", (2, 128, 512)), ("w_down", (2, 256, 128)))}
    monkeypatch.setenv("VOCALIE_MEGATAIL", "0")
    assert tr._dense_dispatch(layers, cfg, 2, 256) == tr.TAIL
    monkeypatch.delenv("VOCALIE_MEGATAIL")
    monkeypatch.setenv("VOCALIE_MEGALAYER", "1")
    assert tr._dense_dispatch(layers, cfg, 2, 256) == tr.MEGALAYER
    # B12 reads the int8 cache: on a bf16 cache the megatail runs, as in JAX
    assert tr._dense_dispatch(layers, dataclasses.replace(cfg, kv_quant=False), 2,
                              256) == tr.MEGATAIL
    # a GELU MLP with biases under RMSNorm: B4 for qkv and o, B9d for the
    # MLP (JAX transformer.py:792-799, :922-941), which the port now has
    gelu = dataclasses.replace(cfg, mlp_type="gelu", bias=True)
    layers["w_up"] = {"q": torch.zeros((2, 128, 256), dtype=torch.int8)}
    assert tr._dense_dispatch(layers, gelu, 2, 256) == tr.DENSE_FNS


#: the modules the CosyVoice slice added
SLICE3_MODULES = (
    "vocalie_tts_tpu_torch.ops.decode_step",
    "vocalie_tts_tpu_torch.engines.base",
    "vocalie_tts_tpu_torch.engines.cosyvoice",
    "vocalie_tts_tpu_torch.models.cosyvoice.model",
    "vocalie_tts_tpu_torch.models.cosyvoice.runtime",
)
#: the modules the AudioSR slice added
SLICE4_MODULES = (
    "vocalie_tts_tpu_torch.ops.groupnorm",
    "vocalie_tts_tpu_torch.models.common.audio",
    "vocalie_tts_tpu_torch.models.common.unet2d",
    "vocalie_tts_tpu_torch.models.common.vocoder",
    "vocalie_tts_tpu_torch.models.audiosr.vae",
    "vocalie_tts_tpu_torch.models.audiosr.model",
    "vocalie_tts_tpu_torch.models.audiosr.runtime",
)
#: the modules the XTTS slice added
SLICE5_MODULES = (
    "vocalie_tts_tpu_torch.io.refs",
    "vocalie_tts_tpu_torch.models.common.speaker",
    "vocalie_tts_tpu_torch.models.xtts.model",
    "vocalie_tts_tpu_torch.models.xtts.runtime",
    "vocalie_tts_tpu_torch.engines.xtts",
)
#: the modules the Qwen3 slice added
SLICE6_MODULES = (
    "vocalie_tts_tpu_torch.models.lmtts.model",
    "vocalie_tts_tpu_torch.models.lmtts.runtime",
    "vocalie_tts_tpu_torch.engines.qwen3",
)
#: the module the whole-layer slice (B12) added
SLICE7_MODULES = ("vocalie_tts_tpu_torch.ops.decode_layer",)
#: the modules the training slice (B6t, B11) added
SLICE9_MODULES = (
    "vocalie_tts_tpu_torch.ops.flash_attention_bwd",
    "vocalie_tts_tpu_torch.parallel.train",
    "vocalie_tts_tpu_torch.training.finetune_fr",
)
#: the modules the Piper/VITS slice added
SLICE22_MODULES = (
    "vocalie_tts_tpu_torch.text.phonemes",
    "vocalie_tts_tpu_torch.text.piper_ids",
    "vocalie_tts_tpu_torch.models.vits.model",
    "vocalie_tts_tpu_torch.models.vits.runtime",
    "vocalie_tts_tpu_torch.engines.piper",
)

#: one child interpreter imports each module alone: it blocks JAX, the JAX
#: package and Triton, imports torch once, and for each module drops every
#: ``vocalie_tts_tpu_torch`` module before importing it, then checks that no
#: kernel library was loaded and no GPU touched
_ALONE = """
import json, sys, importlib, traceback
for m in ('jax', 'jaxlib', 'triton', 'vocalie_tts_tpu'):
    sys.modules[m] = None
import torch
out = {}
for module in json.loads(sys.argv[1]):
    for name in [n for n in sys.modules if n.split('.')[0] == 'vocalie_tts_tpu_torch']:
        del sys.modules[name]
    try:
        importlib.import_module(module)
        from vocalie_tts_tpu_torch.ops import _build
        assert _build._lib is None and not torch.cuda.is_initialized()
        out[module] = 'ok'
    except BaseException:
        out[module] = traceback.format_exc()[-2000:]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def alone():
    """Each listed module's outcome (``"ok"`` or its traceback), imported
    alone in one child interpreter."""
    import json

    modules = (SLICE3_MODULES + SLICE4_MODULES + SLICE5_MODULES + SLICE6_MODULES
               + SLICE7_MODULES + SLICE9_MODULES + SLICE22_MODULES)
    out = subprocess.run([sys.executable, "-c", _ALONE, json.dumps(modules)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", SLICE3_MODULES)
def test_slice3_module_imports_alone(alone, module):
    """Each new module imports on its own with JAX, the JAX package and
    Triton blocked, loads no kernel library and touches no GPU."""
    assert alone[module] == "ok", alone[module]


def test_cosyvoice_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vocalie_tts_tpu_torch.engines.cosyvoice import CosyVoiceEngine
    from vocalie_tts_tpu_torch.models.cosyvoice.runtime import CosyVoiceRuntime
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_KV_INT8", "1")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CosyVoiceRuntime.create(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CosyVoiceEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tts_pipeline({"tts_backend": "cosyvoice", "script": "Bonjour à tous.",
                          "out_path": str(tmp_path / "x.wav")})
    assert not (tmp_path / "x.wav").exists()


@pytest.mark.parametrize("module", SLICE4_MODULES)
def test_slice4_module_imports_alone(alone, module):
    """Each module of the AudioSR slice imports on its own with JAX, the
    JAX package and Triton blocked, loads no kernel library and touches no
    GPU."""
    test_slice3_module_imports_alone(alone, module)


def test_audiosr_runtime_refuses_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vocalie_tts_tpu_torch.models.audiosr.runtime import AudioSRRuntime

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioSRRuntime.create(tmp_path)
    assert AudioSRRuntime.create(tmp_path, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module", SLICE6_MODULES)
def test_slice6_module_imports_alone(alone, module):
    """Each module of the Qwen3 slice imports on its own with JAX, the JAX
    package and Triton blocked, loads no kernel library and touches no
    GPU."""
    test_slice3_module_imports_alone(alone, module)


def test_qwen3_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vocalie_tts_tpu_torch.engines.qwen3 import Qwen3Engine
    from vocalie_tts_tpu_torch.models.lmtts.runtime import LMTTSRuntime
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_KV_INT8", "1")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMTTSRuntime.create(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Qwen3Engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tts_pipeline({"tts_backend": "qwen3", "script": "Bonjour à tous.",
                          "out_path": str(tmp_path / "x.wav")})
    assert not (tmp_path / "x.wav").exists()


@pytest.mark.parametrize("module", SLICE7_MODULES)
def test_slice7_module_imports_alone(alone, module):
    """B12's module imports on its own with JAX, the JAX package and Triton
    blocked, loads no kernel library and touches no GPU."""
    test_slice3_module_imports_alone(alone, module)


@pytest.mark.parametrize("module", SLICE9_MODULES)
def test_slice9_module_imports_alone(alone, module):
    """Each module of the training slice imports on its own with JAX, the JAX
    package and Triton blocked, loads no kernel library and touches no
    GPU."""
    test_slice3_module_imports_alone(alone, module)


@pytest.mark.parametrize("module", SLICE5_MODULES)
def test_slice5_module_imports_alone(alone, module):
    """Each module of the XTTS slice imports on its own with JAX, the JAX
    package and Triton blocked, loads no kernel library and touches no
    GPU."""
    test_slice3_module_imports_alone(alone, module)


def test_xtts_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vocalie_tts_tpu_torch.engines.xtts import XTTSEngine
    from vocalie_tts_tpu_torch.models.xtts.runtime import XTTSRuntime
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_KV_INT8", "1")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XTTSRuntime.create(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        XTTSEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tts_pipeline({"tts_backend": "xtts", "script": "Bonjour à tous.",
                          "voice_ref_path": str(tmp_path / "ref.wav"),
                          "out_path": str(tmp_path / "x.wav")})
    assert not (tmp_path / "x.wav").exists()


@pytest.mark.parametrize("module", SLICE22_MODULES)
def test_piper_module_imports_alone(alone, module):
    """Each module of the Piper/VITS slice imports on its own with JAX, the
    JAX package and Triton blocked, loads no kernel library and touches no
    GPU."""
    test_slice3_module_imports_alone(alone, module)


def test_piper_entry_points_refuse_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from vocalie_tts_tpu_torch.engines.piper import PiperEngine
    from vocalie_tts_tpu_torch.models.vits.runtime import VITSRuntime
    from vocalie_tts_tpu_torch.pipeline import run_tts_pipeline

    monkeypatch.setenv("VOCALIE_MODEL_SCALE", "tiny")
    monkeypatch.setenv("VOCALIE_ALLOW_RANDOM_WEIGHTS", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VITSRuntime.create(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PiperEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_tts_pipeline({"tts_backend": "piper", "script": "Bonjour à tous.",
                          "out_path": str(tmp_path / "x.wav")})
    assert not (tmp_path / "x.wav").exists()
