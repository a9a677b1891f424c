"""Video codecs for the media plane (the port's copy of
ai_rtc_agent_tpu/media/codec.py).

Host-CPU H.264 through the native shim (native/h264.cpp -> distro libavcodec), selected by
HW_ENCODE/HW_DECODE (NVENC/NVDEC accepted as aliases, utils/env.py).

Encoder tuning (NVENC_* spellings accepted as aliases): ENC_PRESET (x264 preset, default ultrafast),
ENC_TUNING_INFO (default zerolatency), ENC_DEFAULT_BITRATE.

``NullCodec`` is the hermetic fallback: "encoded" frames are raw RGB with an
8-byte header — it keeps every byte-stream contract intact for tests and for
environments without libavcodec 5.x.
"""

from __future__ import annotations

import ctypes
import logging
import re
import struct

import numpy as np

from ..utils import env
from . import native

logger = logging.getLogger(__name__)


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class H264Encoder:
    def __init__(
        self,
        width: int,
        height: int,
        fps: int = 30,
        bitrate: int | None = None,
        gop: int = 60,
        preset: str | None = None,
        tune: str | None = None,
    ):
        lib = native.load()
        if lib is None or not lib.tr_h264_available():
            raise RuntimeError("native H.264 not available (libavcodec 5.x required)")
        self._lib = lib
        # each ENC_* accepts the NVENC_* spelling as a lazy alias
        # `is None` (not `or`): an EXPLICIT bitrate=0 / preset="" argument
        # must not silently fall through to the env/default lookup
        if bitrate is None:
            bitrate = env.get_int_aliased(
                "ENC_DEFAULT_BITRATE", "NVENC_DEFAULT_BITRATE", 3_000_000
            )
        if preset is None:
            preset = env.get_str_aliased(
                "ENC_PRESET", "NVENC_PRESET", "ultrafast"
            )
        if tune is None:
            tune = env.get_str_aliased(
                "ENC_TUNING_INFO", "NVENC_TUNING_INFO", "zerolatency"
            )
        # rate-control bounds as x264 VBV
        min_rate = env.get_int_aliased("ENC_MIN_BITRATE", "NVENC_MIN_BITRATE", 0)
        max_rate = env.get_int_aliased("ENC_MAX_BITRATE", "NVENC_MAX_BITRATE", 0)
        if min_rate and not max_rate:
            # x264 honors minrate only under CBR/nal-hrd; a floor with no
            # ceiling is advisory — the operator who set one should know
            # (mirrors the missing-rc-export warning below)
            logger.warning(
                "ENC_MIN_BITRATE set without ENC_MAX_BITRATE: x264 treats a "
                "floor-only bound as advisory (minrate applies under "
                "CBR/nal-hrd); set ENC_MAX_BITRATE to enforce a band"
            )
        # rate/cadence params are kept so reconfigure() can rebuild the
        # encoder with only the changed values
        self._fps = fps
        self._bitrate = bitrate
        self._gop = gop
        self._preset = preset
        self._tune = tune
        self._min_rate = min_rate
        self._max_rate = max_rate
        self._pending = False  # reconfigure awaiting its rebuild-on-IDR
        self.width, self.height = width, height
        self._enc = self._create()
        if not self._enc:
            raise RuntimeError("failed to open H.264 encoder")
        self._buf = np.empty(width * height * 3 + (1 << 16), np.uint8)

    def _create(self):
        lib = self._lib
        if (self._min_rate or self._max_rate) and hasattr(
            lib, "tr_h264_encoder_create_rc"
        ):
            return lib.tr_h264_encoder_create_rc(
                self.width, self.height, self._fps, 1, self._bitrate,
                self._min_rate, self._max_rate, self._gop,
                self._preset.encode(), self._tune.encode()
            )
        if self._min_rate or self._max_rate:
            # a stale committed .so predating the rc export: an operator
            # who set a bandwidth cap must not silently run uncapped
            logger.warning(
                "ENC_MIN/MAX_BITRATE set but the loaded native library "
                "lacks tr_h264_encoder_create_rc — bounds NOT enforced "
                "(rebuild native/)"
            )
        return lib.tr_h264_encoder_create(
            self.width, self.height, self._fps, 1, self._bitrate, self._gop,
            self._preset.encode(), self._tune.encode()
        )

    def reconfigure(
        self,
        *,
        bitrate: int | None = None,
        gop: int | None = None,
        fps: int | None = None,
    ) -> bool:
        """Update rate-control / cadence targets — the ONE blessed mutation
        path for encoder bitrate and GOP (the ``encoder-reconfig`` static
        checker makes any direct native rate call outside this module a
        finding).  Applied in place when the native lib exports
        ``tr_h264_encoder_reconfigure``; otherwise the change is recorded
        and the encoder rebuilds at the next encode boundary — the rebuilt
        stream opens with a fresh IDR + in-band SPS, so receivers re-sync
        onto the new parameters within one frame (rebuild-on-next-IDR).
        Returns True when applied immediately, False while pending."""
        changed = False
        for name, val in (("_bitrate", bitrate), ("_gop", gop), ("_fps", fps)):
            if val is not None and int(val) != getattr(self, name):
                setattr(self, name, max(1, int(val)))
                changed = True
        if not changed:
            return True
        if self._enc and hasattr(self._lib, "tr_h264_encoder_reconfigure"):
            self._lib.tr_h264_encoder_reconfigure(
                self._enc, self._bitrate, self._gop, self._fps
            )
            return True
        self._pending = True
        return False

    def _apply_pending(self):
        if not self._pending or not self._enc:
            return
        self._pending = False
        self._lib.tr_h264_encoder_destroy(self._enc)
        self._enc = self._create()
        if not self._enc:
            raise RuntimeError("failed to reopen H.264 encoder after reconfigure")

    def encode(self, rgb: np.ndarray, pts: int = -1) -> bytes:
        """[H,W,3] uint8 -> annex-B bytes ('' while the encoder buffers)."""
        if self._pending:
            self._apply_pending()
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        key = ctypes.c_int(0)
        n = self._lib.tr_h264_encode(
            self._enc, _u8p(rgb), pts, _u8p(self._buf), self._buf.size,
            ctypes.byref(key),
        )
        if n < 0:
            raise RuntimeError(f"encode failed: {n}")
        return bytes(self._buf[:n])

    def force_keyframe(self):
        """Encode the NEXT frame as an IDR (RTCP-PLI recovery: a viewer that
        dropped an undecodable AU resynchronizes in one frame instead of
        waiting out the gop)."""
        if self._enc and hasattr(self._lib, "tr_h264_force_keyframe"):
            self._lib.tr_h264_force_keyframe(self._enc)

    def flush(self) -> bytes:
        key = ctypes.c_int(0)
        n = self._lib.tr_h264_encode(
            self._enc, None, -1, _u8p(self._buf), self._buf.size, ctypes.byref(key)
        )
        return bytes(self._buf[:n]) if n > 0 else b""

    def close(self):
        if self._enc:
            self._lib.tr_h264_encoder_destroy(self._enc)
            self._enc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class H264Decoder:
    def __init__(self, max_width: int = 4096, max_height: int = 2304):
        lib = native.load()
        if lib is None or not lib.tr_h264_available():
            raise RuntimeError("native H.264 not available (libavcodec 5.x required)")
        self._lib = lib
        self._dec = lib.tr_h264_decoder_create()
        if not self._dec:
            raise RuntimeError("failed to open H.264 decoder")
        self._buf = np.empty(max_width * max_height * 3, np.uint8)

    def decode(self, au: bytes, pts: int = 0):
        """annex-B access unit -> [H,W,3] uint8 ndarray or None (buffering)."""
        data = np.frombuffer(au, np.uint8)
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        opts = ctypes.c_int64(0)
        n = self._lib.tr_h264_decode(
            self._dec, _u8p(data), data.size, pts, _u8p(self._buf), self._buf.size,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(opts),
        )
        if n < 0:
            raise RuntimeError(f"decode failed: {n}")
        if n == 0:
            return None
        frame = self._buf[:n].reshape(h.value, w.value, 3).copy()
        return frame, opts.value

    def flush(self):
        return self.decode(b"", 0)

    def close(self):
        if self._dec:
            self._lib.tr_h264_decoder_destroy(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_EPB_ESCAPE = re.compile(rb"\x00\x00(?=[\x00-\x03])")
_EPB_UNESCAPE = re.compile(rb"\x00\x00\x03(?=[\x00-\x03])")


class NullCodec:
    """Raw passthrough codec (hermetic fallback + tests): frame <-> bytes.

    AUs are annex-B framed (one NAL per frame, start code + emulation
    prevention per H.264 s7.4.1) so they flow through the SAME RTP
    packetize/FU-A/depacketize plane as real H.264 — on a box without
    libavcodec the media path still carries frames end to end instead of
    silently producing zero packets (round-6 host-plane PR)."""

    MAGIC = b"TRAW"

    @staticmethod
    def encode(rgb: np.ndarray, pts: int = 0) -> bytes:
        h, w, _ = rgb.shape
        raw = NullCodec.MAGIC + struct.pack("<HHq", w, h, pts) + rgb.tobytes()
        # escape 00 00 0x runs so raw pixels can never fake a start code
        # mid-AU (the packetizer's NAL scanner would split the frame)
        return b"\x00\x00\x00\x01" + _EPB_ESCAPE.sub(b"\x00\x00\x03", raw)

    @staticmethod
    def decode(data: bytes):
        data = bytes(data)
        if data[:4] == b"\x00\x00\x00\x01":
            data = data[4:]
        elif data[:3] == b"\x00\x00\x01":
            data = data[3:]
        data = _EPB_UNESCAPE.sub(b"\x00\x00", data)
        if data[:4] != NullCodec.MAGIC:
            raise ValueError("not a NullCodec frame")
        w, h, pts = struct.unpack("<HHq", data[4:16])
        arr = np.frombuffer(data[16:], np.uint8).reshape(h, w, 3)
        return arr, pts


def make_encoder(width: int, height: int, fps: int = 30):
    """HW_ENCODE -> native H.264, else None (the caller's NullCodec)."""
    if env.hw_encode() and native.h264_available():
        return H264Encoder(width, height, fps)
    return None


def make_decoder():
    if env.hw_decode() and native.h264_available():
        return H264Decoder()
    return None
