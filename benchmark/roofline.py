"""The yardstick's arithmetic: the chip's peaks, a kernel's bound, the
attention work of a model pass from the shapes its configuration's family
gives, and the work of a frame counted by that family over its plain
reference.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s in
bf16, 3.35 TB/s of HBM3.  A bound is the larger of operations over the
peak rate and bytes over the bandwidth; each input byte is counted read
once and each output byte written once.
"""

from __future__ import annotations

from . import families

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take for this work (s)."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def attention_shapes(cfg: dict, rows: int) -> list:
    """(B, Lq, Lk, H, D) of every attention launch of one model pass over
    ``rows`` latent rows, from the configuration's family (families.py)."""
    return families.of(cfg).attention_shapes(cfg, rows)


def attention_work(shape, elem_bytes: int = 2) -> tuple:
    """(operations, bytes) of one attention launch: 4·B·H·Lq·Lk·D, and Q,
    K, V and O each moved once in bf16."""
    b, lq, lk, hh, d = shape
    return 4.0 * b * hh * lq * lk * d, elem_bytes * b * hh * d * (2 * lq + 2 * lk)


def attention_bound_s(cfg: dict, rows: int) -> float:
    """Σ over one model pass's attention launches of each launch's bound (s)."""
    return sum(bound_s(*attention_work(s)) for s in attention_shapes(cfg, rows))


def frame_flops(cfg: dict) -> float:
    """Floating-point operations of one served frame, counted by the
    configuration's family over its plain reference (families.py)."""
    return families.of(cfg).frame_flops(cfg)
