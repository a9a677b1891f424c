"""Build the package's CUDA sources into shared libraries at first use.

Sources live in ``ai_rtc_agent_tpu_torch/csrc``; outputs go to ``build/`` at
the root of the checkout (listed in .gitignore), named by a digest of the
source and flags so an edited source never loads a stale library.  The
libraries have a plain C interface and are loaded with ctypes; nothing here
includes PyTorch's headers, so one source builds in seconds.  A build
reports its seconds to the device telemetry's build watchdog
(obs/devtel.py), attributed to ``nvcc:<source>``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ...obs import devtel

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_source_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (rc={proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    devtel.note_build(time.perf_counter() - t0, f"nvcc:{source}")
    return out


def load_library(source: str) -> ctypes.CDLL:
    """Build (first use) and load one source; two sources build in parallel."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source)))
            _loaded[source] = lib
        return lib
