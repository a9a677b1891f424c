"""ctypes binding to the native media runtime: the frame ring, RTP and the
H.264 shim of ``native/*.cpp`` (the port's counterpart of
ai_rtc_agent_tpu/media/native.py).

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` into ``build/`` at the root of the checkout (listed in
.gitignore), named by a digest of the sources and flags, as the CUDA
kernels are (ops/kernels/build.py).  Nothing is written under ``native/``.
The library has no build-time dependencies; libavcodec is ``dlopen``ed at
run time, so H.264 is available only where libavcodec 5.x is.

A missing toolchain or a failed build gives ``None``, as in the JAX package:
the consumers then take the pure-Python RTP path and ``NullCodec``
(media/rtp.py, media/codec.py), and ``load_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..obs import devtel
from ..ops.kernels.build import BUILD_DIR
from ..utils import env

logger = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("frame_ring.cpp", "rtp.cpp", "h264.cpp")  # native/Makefile's SRCS
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-ldl")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None
build_seconds: float | None = None  # wall time of this process's build (None: reused)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for name in SOURCES:
        digest.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libtpurtc-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``native/*.cpp`` into ``build/`` unless already built there."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(env.get_str("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXXFLAGS, *(str(NATIVE_DIR / s) for s in SOURCES), "-o", str(tmp), *LDFLAGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/ (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    devtel.note_build(build_seconds, "g++:native")  # the build watchdog (obs/devtel.py)
    return out


def load() -> ctypes.CDLL | None:
    """The runtime, built and loaded once per process; None without it."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _error = str(e)
            logger.warning("native media runtime unavailable (%s); using python fallbacks", e)
            return None
        _declare(lib)
        _lib = lib
        return lib


def load_error() -> str | None:
    """Why :func:`load` gave None (None when it loaded or was not tried)."""
    return _error


def _declare(lib: ctypes.CDLL):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)

    lib.tr_ring_create.restype = c.c_void_p
    lib.tr_ring_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.tr_ring_destroy.argtypes = [c.c_void_p]
    lib.tr_ring_try_push.restype = c.c_int
    lib.tr_ring_try_push.argtypes = [c.c_void_p, u8p, c.c_int64, c.c_int64]
    lib.tr_ring_push_latest.restype = c.c_int
    lib.tr_ring_push_latest.argtypes = [c.c_void_p, u8p, c.c_int64, c.c_int64]
    lib.tr_ring_try_pop.restype = c.c_int64
    lib.tr_ring_try_pop.argtypes = [c.c_void_p, u8p, c.c_int64, c.POINTER(c.c_int64)]
    lib.tr_ring_size.restype = c.c_int64
    lib.tr_ring_size.argtypes = [c.c_void_p]
    lib.tr_ring_dropped.restype = c.c_int64
    lib.tr_ring_dropped.argtypes = [c.c_void_p]

    lib.tr_rtp_packetizer_create.restype = c.c_void_p
    lib.tr_rtp_packetizer_create.argtypes = [c.c_uint32, c.c_uint8, c.c_int32]
    lib.tr_rtp_packetizer_destroy.argtypes = [c.c_void_p]
    lib.tr_rtp_packetize.restype = c.c_int64
    lib.tr_rtp_packetize.argtypes = [c.c_void_p, u8p, c.c_int64, c.c_uint32, u8p, c.c_int64]
    lib.tr_rtp_depacketizer_create.restype = c.c_void_p
    lib.tr_rtp_depacketizer_destroy.argtypes = [c.c_void_p]
    lib.tr_rtp_depacketize.restype = c.c_int
    lib.tr_rtp_depacketize.argtypes = [c.c_void_p, u8p, c.c_int64]
    lib.tr_rtp_get_au.restype = c.c_int64
    lib.tr_rtp_get_au.argtypes = [c.c_void_p, u8p, c.c_int64, c.POINTER(c.c_uint32)]

    lib.tr_h264_available.restype = c.c_int
    lib.tr_h264_encoder_create.restype = c.c_void_p
    lib.tr_h264_encoder_create.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int64, c.c_int, c.c_char_p, c.c_char_p,
    ]
    lib.tr_h264_encoder_create_rc.restype = c.c_void_p
    lib.tr_h264_encoder_create_rc.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int64, c.c_int64,
        c.c_int64, c.c_int, c.c_char_p, c.c_char_p,
    ]
    lib.tr_h264_encode.restype = c.c_int64
    lib.tr_h264_encode.argtypes = [c.c_void_p, u8p, c.c_int64, u8p, c.c_int64, c.POINTER(c.c_int)]
    lib.tr_h264_encoder_destroy.argtypes = [c.c_void_p]
    lib.tr_h264_force_keyframe.argtypes = [c.c_void_p]
    lib.tr_h264_decoder_create.restype = c.c_void_p
    lib.tr_h264_decode.restype = c.c_int64
    lib.tr_h264_decode.argtypes = [
        c.c_void_p, u8p, c.c_int64, c.c_int64, u8p, c.c_int64,
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.POINTER(c.c_int64),
    ]
    lib.tr_h264_decoder_destroy.argtypes = [c.c_void_p]


def h264_available() -> bool:
    lib = load()
    return bool(lib and lib.tr_h264_available())
