"""Build and load the port's CUDA kernels (lazily, at first launch).

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` (Hopper), then linked into ONE shared
library with a plain C interface that ``ctypes`` loads. The library's
name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing here runs at import
time: a machine without ``nvcc`` imports the package and uses the plain
PyTorch versions for CPU tensors.

Build outputs go to ``build/kernels/`` at the repository root (listed in
``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("decode_attention.cu", "cache_update.cu", "flash_attention.cu", "decode_dense.cu",
           "decode_step.cu", "groupnorm.cu", "decode_layer.cu", "flash_attention_bwd.cu",
           "tail_swiglu.cu", "tail_gelu.cu", "dense_int8.cu")
FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: Dict[str, ctypes._CFuncPtr] = {}
_log: List[str] = []


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "compiled from csrc/ at their first launch"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    tag = _digest()
    out_dir = BUILD_DIR
    lib_path = out_dir / f"libvocalie_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    objs = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}_{tag}.o"
        cmd = [nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(str(obj))
    failed = []
    for name, proc in procs:
        text, _ = proc.communicate()
        _log.append(f"== nvcc {name} (rc {proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(_log))
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, FLAGS[0], "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    _log.append(f"== link (rc {link.returncode})\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """nvcc's output (including ``-Xptxas -v`` register and shared-memory
    use) from this process's build, empty when the library was reused."""
    return "\n".join(_log)


def kernel(name: str, argtypes: Sequence, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the kernel library, building and
    loading the library at first use. Launching entry points return a
    ``cudaError_t`` as int (0 on success); ``restype`` is for the others."""
    global _lib
    fn = _fns.get(name)   # the hot path: no lock once the entry point is bound
    if fn is not None:
        return fn
    with _lock:
        fn = _fns.get(name)
        if fn is not None:
            return fn
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        fn = getattr(_lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _fns[name] = fn
        return fn


#: what an entry point's refusal means, where the cudaError alone says little
_HINTS = {716: " (misaligned address: an input the kernel reads in 16-byte chunks does not "
               "start on a 16-byte boundary)"}


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}"
                           + _HINTS.get(rc, ""))


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

__all__ = ["build", "build_log", "kernel", "check", "stream_ptr", "SOURCES", "BUILD_DIR"]
