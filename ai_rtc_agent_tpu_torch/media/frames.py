"""VideoFrame: the duck-typed frame contract of the media plane
(counterpart of ai_rtc_agent_tpu/media/frames.py).

A frame is ``to_ndarray(format="rgb24")`` plus ``pts`` and ``time_base``,
so a real ``av.VideoFrame`` interoperates where PyAV is installed and the
tests and the loopback tier can make frames without it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np


@dataclass
class VideoFrame:
    _rgb: np.ndarray  # [H,W,3] uint8
    pts: int | None = None
    time_base: Fraction | None = None
    # wall-clock of decode completion, carried to the output for freshness
    wall_ts: float | None = None
    # the frame's lifecycle trace (obs/trace.py FrameTrace), None unless a
    # plane minted one; it rides the frame so every hop can stamp it
    trace: object = field(default=None, repr=False, compare=False)

    @classmethod
    def from_ndarray(cls, arr: np.ndarray, format: str = "rgb24") -> "VideoFrame":
        if format != "rgb24":
            raise ValueError(f"unsupported format: {format}")
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"expected HxWx3, got {arr.shape}")
        return cls(_rgb=arr)

    def to_ndarray(self, format: str = "rgb24") -> np.ndarray:
        if format != "rgb24":
            raise ValueError(f"unsupported format: {format}")
        return self._rgb


def wrap_processed(out_u8: np.ndarray, src_frame) -> VideoFrame:
    """Wrap a processed frame with the source frame's timing metadata
    (pts, time_base, wall_ts) and its trace: the encode and send hops stamp
    the source frame's timeline through the processed output."""
    vf = VideoFrame.from_ndarray(out_u8)
    vf.pts = src_frame.pts
    vf.time_base = src_frame.time_base
    vf.wall_ts = getattr(src_frame, "wall_ts", None)
    vf.trace = getattr(src_frame, "trace", None)
    return vf
