"""Build the package's CUDA sources with ``nvcc``, load them with ``ctypes``,
and launch them with as little host work per call as possible.

Each library is compiled once per content hash of its sources, the
headers in ``csrc/`` and the flags into ``build/ceres_slam_tpu_torch/``
at the repository root (the directory ``.gitignore`` lists), at first
use, and loaded into the process. The sources expose a plain C interface (pointers and the stream as ``void*``),
so no PyTorch header is compiled and a build takes seconds.

The thin launch path (K1 and K4): ``load`` sets every C function's
``argtypes`` once, when the library is loaded; the inputs that are fixed
over a problem are checked once, when the kernel's plan is built, and
reach the C side as one argument struct; a call checks only its own
tensors, allocates its outputs with one ``torch.empty``, reads the raw
current stream (``current_stream``, no ``torch.cuda.device`` context) and
raises on the ``cudaGetLastError()`` code the C function returns. The C
side switches to the plan's device only where more than one is visible.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ceres_slam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update((CSRC / s).read_bytes())
    for header in sorted(CSRC.glob("*.h")):  # any source may include any of them
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, sources: tuple[str, ...], signatures: dict | None = None) -> ctypes.CDLL:
    """Compile (if this content hash was never built) and load a library.
    ``signatures`` maps C function names to their ``argtypes``, set here
    once (each returns an ``int`` CUDA error code). The ``nvcc`` output,
    including ``-Xptxas -v``'s register and shared memory report, is kept
    beside the library as ``<library>.log``."""
    if name in _loaded:
        return _loaded[name]
    out = library_path(name, sources)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in (signatures or {}).items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


# current_stream(device_index): the raw handle of PyTorch's current stream
# on a device, as Triton's launcher reads it: one C call, no
# torch.cuda.Stream object and no device context (chip_smoke.py times it
# against torch.cuda.current_stream(device).cuda_stream). None where
# PyTorch is built without CUDA.
current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_error(err: int, name: str) -> RuntimeError:
    """The error for a nonzero ``cudaGetLastError()`` code of a launch: a
    refused launch never runs, and a later synchronize would not report it."""
    return RuntimeError(f"{name} launch failed with CUDA error {err}")
